"""Model families (params dicts keyed by HF names, plain functions)."""
