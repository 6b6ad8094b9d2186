"""Entity resolution on the card: featurization, blocking, the stage-2
verifier, the synthetic datasets, the match-job compiler and the
end-to-end pipeline — the single-host slice of ``repro.er``."""
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
    MatchJob,
    NoHealthyDevicesError,
    Schedule,
    TileCatalog,
    cross_job,
    execute,
    lower,
    match_catalog,
    plan_to_job,
    schedule_tiles,
    score_catalog,
    stage1_stats,
    tile_costs,
    verify_pairs,
)
from .pipeline import (ERConfig, ERResult, JobPlan, compile_catalog,  # noqa: F401
                       cross_restrict, featurize, plan_job, run_er)
from .similarity import edit_distance, edit_similarity  # noqa: F401
