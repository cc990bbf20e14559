"""Deploy-time serving: safetensors, family detection, loader, HTTP sidecar."""
