"""Match-job compiler: plan → catalog → schedule → execute.

Port of ``repro.er.compiler``. ``ir``, ``lower``, ``schedule``,
``comms``, ``feedback``, ``tune`` and ``faults`` are numpy copies (the
plan IR, tiling, the exact cost-LPT scheduler with its EWMA calibration,
the mesh's locality and byte planner, the geometry autotuner and the
fault scripts); ``execute`` drives the CUDA catalog kernels on one device,
on a device mesh (``make_scorer``), or under the fault-tolerant
supervisor.
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
from .comms import (  # noqa: F401
    COMMS_POLICIES,
    CommsPlan,
    comms_volume,
    default_group,
    halo_bytes_per_device,
    halo_hop_rows,
    plan_comms,
    psum_bytes_per_device,
    rewrite_tiles_local,
)
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
    CatalogScorer,
    RecoveryFailedError,
    ShardRecord,
    SupervisedReport,
    execute,
    execute_supervised,
    make_scorer,
    match_catalog,
    score_catalog,
    shard_sane,
    stage1_stats,
    stage2_stats,
    verify_pairs,
)
