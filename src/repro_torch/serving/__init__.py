from repro_torch.serving.engine import (  # noqa: F401
    Engine, Request, SamplingParams, sample_token,
)
from repro_torch.serving.disagg import (  # noqa: F401
    DecoderAdapter, GatewayStats, PDCluster, PrefillerInstance,
)
from repro_torch.serving.kvtransfer import (  # noqa: F401
    KVPayload, TransferStats, extract, insert, payload_bytes, transfer,
)
