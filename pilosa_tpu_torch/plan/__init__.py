"""Query-plan compiler (docs/query-compiler.md).

Canonical lowering of PQL call trees: commutative-operand sorting, k-ary
flattening of associative chains, leaf-slot assignment, and the
injective structure signature that keys the engine's compiled-program
cache, the result memo, the micro-batcher's coalescing groups, and the
per-signature device breaker. jax-free (pilint R2): the jnp lowering of
the emitted IR lives in parallel/engine.py.
"""

from .signature import (  # noqa: F401
    CompiledPlan,
    Leaf,
    NARY_OPS,
    PlanStats,
    SETOP_KINDS,
    STATS,
    build_plan,
    cached_plan,
    resolve_time_range,
    snapshot,
)
