"""Client side of the registry (counterpart of ``modelx_tpu/client``, pull
side): the typed HTTP client, the pull engine and its data-plane
extensions, on the standard library's ``http.client``."""
