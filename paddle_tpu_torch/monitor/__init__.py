"""Telemetry (counterpart of ``paddle_tpu/monitor``): the P² latency
digests the serving engine's ``stats()`` reports (``host_gap_ms``,
``spec_accept_len``). The registry, tracing, health and accounting
modules come with a later slice."""
from .digest import LatencyDigest, P2Quantile

__all__ = ["LatencyDigest", "P2Quantile"]
