"""The training runtime: int8 compressed all-reduce with error feedback,
elastic re-mesh planning, checkpoint/restart, fault injection and the
straggler watchdog (the counterparts of ``repro.runtime``)."""
from repro_torch.runtime.compression import (
    compress_with_feedback,
    compressed_psum,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
    tree_compressed_psum,
)
from repro_torch.runtime.elastic import ElasticDecision, plan_elastic_mesh
from repro_torch.runtime.fault_tolerance import (
    InjectedFault,
    RunReport,
    StragglerAlert,
    TrainRunner,
)

__all__ = [
    "compress_with_feedback", "compressed_psum", "dequantize_int8", "init_error_feedback",
    "quantize_int8", "tree_compressed_psum", "ElasticDecision",
    "plan_elastic_mesh", "InjectedFault", "RunReport", "StragglerAlert",
    "TrainRunner",
]
