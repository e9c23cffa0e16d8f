"""Ramulator2-style CD-PIM performance model (the paper's evaluation layer):
the port's own copy of ``repro.pimsim``, module for module and float for
float. It prices the paper's LPDDR5-PIM edge devices (``JETSON``,
``IPHONE``), never the GPU the port runs on: its seconds are simulated
seconds of that device model. ``replay_events`` prices the port engine's
``ScheduleEvent`` stream as the JAX package prices the JAX engine's."""
from repro_torch.pimsim.device import DEVICES, IPHONE, JETSON, DeviceSpec  # noqa: F401
from repro_torch.pimsim.latency import (  # noqa: F401
    StageBreakdown,
    gpu_decode_step_time,
    gpu_only_e2e,
    gpu_prefill_time,
    hbcem_e2e,
    pim_decode_step_time,
    verify_step_time,
)
from repro_torch.pimsim.llm import LLAMA_1B, LLAMA_7B, LLAMA_13B, MODELS, LLMSpec  # noqa: F401
from repro_torch.pimsim.pim import (  # noqa: F401
    ATTACC,
    CDPIM,
    CDPIM_FIXED_MAPPING,
    CONVENTIONAL,
    DESIGNS,
    DH_PIM,
    FOLD_PIM,
    PIPE_PIM,
    PIMDesign,
)
from repro_torch.pimsim.scheduler import (  # noqa: F401
    ReplayReport,
    Trace,
    blocked_trace,
    clock_to_time,
    lbim_e2e,
    replay_events,
)
