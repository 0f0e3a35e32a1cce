"""LLM inference for the port, on the card: batch inference over the Data
library (`Processor`: the model runs in actor-pool workers, one GPU each),
the inference worker, continuous batching, and the serving classes with
their Serve deployments.

    import cluster_anywhere_tpu_torch as ca
    import cluster_anywhere_tpu_torch.data as cad
    from cluster_anywhere_tpu_torch import llm

    ca.init()
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny"), batch_size=8)
    processor = llm.build_llm_processor(
        cfg, preprocess=lambda row: {"prompt": row["text"]}
    )
    out_ds = processor(cad.from_items([{"text": "hello"}]))
    rows = out_ds.take_all()  # each with "generated_tokens" and "generated_text"
"""

from .continuous import ContinuousBatcher, Request
from .processor import (
    ByteTokenizer,
    ModelSpec,
    Processor,
    ProcessorConfig,
    build_llm_processor,
)
from .serve_llm import (
    ContinuousLLMServer,
    LLMServer,
    StreamingLLMIngress,
    build_continuous_llm_deployment,
    build_llm_deployment,
)

__all__ = [
    "ProcessorConfig",
    "ModelSpec",
    "Processor",
    "ByteTokenizer",
    "build_llm_processor",
    "LLMServer",
    "build_llm_deployment",
    "ContinuousBatcher",
    "Request",
    "ContinuousLLMServer",
    "StreamingLLMIngress",
    "build_continuous_llm_deployment",
]
