"""Match-job compiler, single host: plan → catalog → schedule → execute.

Port of ``repro.er.compiler``. ``ir``, ``lower``, ``schedule``,
``feedback``, ``tune`` and ``faults`` are numpy copies (the plan IR,
tiling, the exact cost-LPT scheduler with its EWMA calibration, the
geometry autotuner and the fault scripts); ``execute`` drives the CUDA
catalog kernels, alone or under the fault-tolerant supervisor. The mesh
(``comms`` beyond its policy names) comes with a later slice.
"""
from .ir import (  # noqa: F401
    A_TILE, B_TILE, R0, R1, C0, C1, TRI, LB_R, LB_C, UB_R, UB_C, BAND, RED,
    NCOLS,
    MatchJob,
    TileCatalog,
    cross_job,
    make_job,
    plan_to_job,
    task_row,
)
from .lower import (  # noqa: F401
    enumerate_catalog_pairs,
    enumerate_task_pairs,
    lower,
    pad_catalog,
    pad_tiles,
    task_tiles,
)
from .comms import COMMS_POLICIES  # noqa: F401
from .schedule import (  # noqa: F401
    NoHealthyDevicesError,
    Schedule,
    apply_schedule,
    device_assignment,
    schedule_tiles,
    tile_costs,
    tiles_for_devices,
)
from .feedback import (  # noqa: F401
    N_TILE_CLASSES,
    TILE_CLASS_NAMES,
    EwmaCostModel,
    GeometryCostModel,
    tile_class,
)
from .tune import (  # noqa: F401
    GEOMETRY_LATTICE,
    GeometryScore,
    TuneReport,
    autotune,
    catalog_occupancy,
)
from .faults import (  # noqa: F401
    FAULT_KINDS,
    CallPlan,
    DeviceKilledError,
    FaultEvent,
    FaultInjector,
    FaultScript,
    TransientScorerError,
)
from .execute import (  # noqa: F401
    RecoveryFailedError,
    ShardRecord,
    SupervisedReport,
    execute,
    execute_supervised,
    match_catalog,
    score_catalog,
    shard_sane,
    stage1_stats,
    verify_pairs,
)
