"""Compute ops: Poincaré geometry, horosphere predicates, attention, int8 matmuls."""

from .poincare import (  # noqa: F401
    MIN_NORM,
    PoincareBall,
    arcosh,
    artanh,
    ball_eps,
    dist,
    dist0,
    egrad2rgrad,
    expmap,
    expmap0,
    gyration,
    inner,
    lambda_x,
    logmap0,
    mobius_add,
    mobius_fn_apply,
    mobius_matvec,
    mobius_scalar_mul,
    pairwise_dist,
    project,
    ptransp,
)
from .horosphere import (  # noqa: F401
    disjointedness,
    disjointedness_unit,
    hmi_logit,
    insideness,
    insideness_unit,
)
