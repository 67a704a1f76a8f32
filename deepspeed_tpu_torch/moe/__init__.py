from .dropless import (  # noqa: F401
    dropless_apply,
    dropless_topk_gating,
    expert_counts,
    grouped_mm,
    router_z_loss,
    sort_by_expert,
)
