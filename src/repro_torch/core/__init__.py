"""Host planning for the port: numpy copies of ``repro.core`` — BDM,
Basic, BlockSplit, PairRange, Sorted Neighborhood and the two-source
extension. The jit-able ``*_jnp`` twins are ported as ``*_torch``
(static shapes, any device): ``greedy_lpt_torch``, ``compute_bdm_torch``,
``entity_indices_torch`` and ``pairs_of_range_torch``, which the legacy
mesh executor uses."""
from . import enumeration  # noqa: F401
from .assignment import (  # noqa: F401
    greedy_lpt,
    greedy_lpt_hetero,
    greedy_lpt_torch,
    makespan_stats,
)
from .basic import BasicPlan, plan_basic  # noqa: F401
from .bdm import (  # noqa: F401
    blocked_layout,
    compute_bdm,
    compute_bdm_torch,
    entity_indices,
    entity_indices_torch,
    update_bdm,
)
from .block_split import BlockSplitPlan, plan_block_split  # noqa: F401
from .sorted_neighborhood import (  # noqa: F401
    SortedNeighborhoodPlan,
    band_pair_count,
    pairs_of_band_range,
    plan_sorted_neighborhood,
)
from .pair_range import (  # noqa: F401
    PairRangePlan,
    entity_range_matrix,
    map_output_size,
    pairs_of_range,
    pairs_of_range_torch,
    plan_pair_range,
    range_block_intervals,
)
from .two_source import (  # noqa: F401
    BlockSplit2Plan,
    PairRange2Plan,
    TwoSourceBDM,
    pairs_of_range_2src,
    plan_block_split_2src,
    plan_pair_range_2src,
    range_block_segments_2src,
)
