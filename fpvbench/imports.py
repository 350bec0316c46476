"""The rule that the benchmark never runs the JAX package: a module counts
when the part of its name before the first dot is one of these, compared
whole (``fpv_tpu_torch`` is the port, ``fpv_tpu`` the JAX package)."""

from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "fpv_tpu")


def forbidden(module_names) -> list[str]:
    """The top-level names among ``module_names`` that are forbidden."""
    tops = {name.split(".", 1)[0] for name in module_names}
    return sorted(tops.intersection(FORBIDDEN))
