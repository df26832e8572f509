from repro_torch.serving.engine import Engine, GenStats  # noqa: F401
from repro_torch.serving.errors import (  # noqa: F401
    DeadlineExceeded, DeadlineUnmeetable, InvalidRequest,
    InvariantViolation, QueueFull, RequestCancelled, RequestFailed,
    ServingError, ShuttingDown, TransientFault, WatchdogTimeout,
    error_for_reason,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    Request, RequestState, Scheduler, tighten_policy,
)
from repro_torch.serving.step import (  # noqa: F401
    StepFns, build_step_fns, decode_steps_fused, gate_probe, make_fused,
)
from repro_torch.serving import errors, sampler  # noqa: F401
