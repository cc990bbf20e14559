"""Deterministic test harnesses shipped with the package: fault injection
lives here so env-gated chaos drills and the test suite share one
implementation (counterpart of ``modelx_tpu/testing``)."""
