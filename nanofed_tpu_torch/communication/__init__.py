"""The network mode (counterpart of ``nanofed_tpu/communication/``): binary npz and
compressed (q8, topk8) payloads over HTTP, the round engine (sync rounds, validated,
robust and secure; async FedBuff), signatures and secure aggregation over the wire.
Needs ``aiohttp`` to build a server or client, not to import; the codec is numpy
only."""

from nanofed_tpu_torch.communication.codec import (
    ENCODING_Q8_DELTA,
    ENCODING_TOPK8,
    decode_delta_q8,
    decode_delta_topk8,
    decode_params,
    encode_delta_q8,
    encode_delta_topk8,
    encode_params,
    reconstruct_q8,
    reconstruct_topk8,
)
from nanofed_tpu_torch.communication.http_client import (
    ClientEndpoints,
    HTTPClient,
    SecAggRoster,
)
from nanofed_tpu_torch.communication.http_server import HTTPServer, ServerEndpoints
from nanofed_tpu_torch.communication.network_coordinator import (
    NetworkCoordinator,
    NetworkRoundConfig,
    fedbuff_combine,
    stack_model_updates,
)
from nanofed_tpu_torch.communication.retry import (
    RETRYABLE_STATUSES,
    RetryPolicy,
    parse_retry_after,
)
from nanofed_tpu_torch.communication.transport import (
    HEADER_TENANT,
    HTTPTransport,
    free_port,
    tenant_base_url,
)

__all__ = [
    "ClientEndpoints",
    "ENCODING_Q8_DELTA",
    "ENCODING_TOPK8",
    "HEADER_TENANT",
    "HTTPClient",
    "HTTPServer",
    "HTTPTransport",
    "NetworkCoordinator",
    "NetworkRoundConfig",
    "RETRYABLE_STATUSES",
    "RetryPolicy",
    "SecAggRoster",
    "ServerEndpoints",
    "decode_delta_q8",
    "decode_delta_topk8",
    "decode_params",
    "encode_delta_q8",
    "encode_delta_topk8",
    "encode_params",
    "fedbuff_combine",
    "free_port",
    "parse_retry_after",
    "reconstruct_q8",
    "reconstruct_topk8",
    "stack_model_updates",
    "tenant_base_url",
]
