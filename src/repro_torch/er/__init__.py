"""Entity resolution on the card: featurization, blocking, similarity,
the synthetic datasets, the match-job compiler (with tuning, feedback,
the fault-tolerant supervisor and the mesh executor), the end-to-end
pipeline, the resident service with its batcher, and the mesh runtime
(``er.distributed``) — the port of ``repro.er``."""
from .blocking import (  # noqa: F401
    dense_block_ids,
    exponential_block_ids,
    prefix_block_ids,
    sn_sort_keys,
    sn_sort_order,
)
from .datasets import Dataset, make_products, make_publications  # noqa: F401
from .encode import encode_titles, ngram_features  # noqa: F401
from .compiler import (  # noqa: F401
    DeviceKilledError,
    EwmaCostModel,
    FaultEvent,
    FaultInjector,
    FaultScript,
    MatchJob,
    NoHealthyDevicesError,
    RecoveryFailedError,
    Schedule,
    SupervisedReport,
    TileCatalog,
    TransientScorerError,
    cross_job,
    execute,
    execute_supervised,
    lower,
    match_catalog,
    plan_to_job,
    schedule_tiles,
    score_catalog,
    stage1_stats,
    stage2_stats,
    tile_costs,
    verify_pairs,
)
from .executor import build_catalog  # noqa: F401
from .pipeline import (ERConfig, ERResult, JobPlan, compile_catalog,  # noqa: F401
                       cross_restrict, encode_stats, featurize, plan_job,
                       run_er)
from .service import (  # noqa: F401
    ERService,
    MatchResponse,
    ServiceConfig,
    ServiceUnavailable,
    compile_counter,
)
from .batcher import AdmissionError, ERBatcher  # noqa: F401
from .similarity import (  # noqa: F401
    cosine_scores,
    edit_distance,
    edit_similarity,
    two_stage_match,
)
