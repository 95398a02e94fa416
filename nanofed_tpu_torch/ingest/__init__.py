"""Batched device-resident ingest (counterpart of ``nanofed_tpu/ingest/``): a
FedBuff-style ``[capacity, P]`` buffer of client deltas on the card, drained by one
batched product a round or aggregation instead of one host stack per client, behind
a bounded decode pool.  A full buffer answers 429 + Retry-After at the HTTP layer.
The partial drains are the host-local stage of a hierarchical federation
(``communication.federation``)."""

from nanofed_tpu_torch.ingest.buffer import DeviceIngestBuffer, IngestConfig, SlotMeta
from nanofed_tpu_torch.ingest.pipeline import (
    IngestPipeline,
    flatten_params,
    weight_from_metrics,
)

__all__ = [
    "DeviceIngestBuffer",
    "IngestConfig",
    "IngestPipeline",
    "SlotMeta",
    "flatten_params",
    "weight_from_metrics",
]
