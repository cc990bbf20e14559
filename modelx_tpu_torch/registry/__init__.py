"""Registry server side (counterpart of ``modelx_tpu/registry``, the local
FS store): storage providers, the FS store and the HTTP server."""
