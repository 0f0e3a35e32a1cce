"""LLM serving for the port: the inference worker, continuous batching, the
serving classes and their Serve deployments, on the card.

    from cluster_anywhere_tpu_torch import llm
    srv = llm.ContinuousLLMServer(llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny")))
    srv({"prompt": "hello"})
    srv.close()
"""

from .continuous import ContinuousBatcher, Request
from .processor import ByteTokenizer, ModelSpec, ProcessorConfig
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
    "ByteTokenizer",
    "LLMServer",
    "build_llm_deployment",
    "ContinuousBatcher",
    "Request",
    "ContinuousLLMServer",
    "StreamingLLMIngress",
    "build_continuous_llm_deployment",
]
