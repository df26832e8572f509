from repro_torch.serving.engine import Engine, GenStats  # noqa: F401
from repro_torch.serving.errors import (  # noqa: F401
    DeadlineExceeded, DeadlineUnmeetable, InvalidRequest,
    InvariantViolation, QueueFull, RequestCancelled, RequestFailed,
    ServingError, ShuttingDown, TransientFault, WatchdogTimeout,
    error_for_reason,
)
from repro_torch.serving.faults import (  # noqa: F401
    Fault, FaultInjector, InjectedFault, SimulatedCrash, sample_campaign,
)
from repro_torch.serving.frontdoor import (  # noqa: F401
    FrontDoor, RecoveryReport, TokenStream, recover,
)
from repro_torch.serving.journal import (  # noqa: F401
    JournalTail, JournalWriter, Snapshot, fold_records, load_snapshot,
    read_journal, save_snapshot,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    Request, RequestState, Scheduler, tighten_policy,
)
from repro_torch.serving.spec_decode import (  # noqa: F401
    SpecResult, greedy_accept, rollback_cur_len,
)
from repro_torch.serving.spec_scheduler import (  # noqa: F401
    SpecConfig, SpecScheduler,
)
from repro_torch.serving.step import (  # noqa: F401
    SpecStepFns, StepFns, build_spec_fns, build_step_fns,
    decode_steps_fused, gate_probe, make_fused, make_spec_fused,
    spec_steps_fused,
)
from repro_torch.serving import errors, faults, sampler  # noqa: F401
