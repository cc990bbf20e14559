"""Host-side helpers with no device work."""
