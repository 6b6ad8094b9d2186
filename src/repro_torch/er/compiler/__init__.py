"""Match-job compiler, single host: plan → catalog → schedule → execute.

Port of ``repro.er.compiler``. ``ir``, ``lower`` and ``schedule`` are
numpy copies (the plan IR, tiling, and the exact cost-LPT scheduler);
``execute`` drives the CUDA catalog kernels. Tuning, feedback, the
supervisor and the mesh come with later slices.
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
from .schedule import (  # noqa: F401
    NoHealthyDevicesError,
    Schedule,
    apply_schedule,
    device_assignment,
    schedule_tiles,
    tile_costs,
    tiles_for_devices,
)
from .execute import (  # noqa: F401
    execute,
    match_catalog,
    score_catalog,
    stage1_stats,
    verify_pairs,
)
