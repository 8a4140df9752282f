"""Compute ops of the port: Riccati cache, condensed maps, the single-instance
ADMM and its projections, CUDA kernels."""


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error of a JAX feature the port does not have yet, naming the
    ROADMAP.md item that ports it."""
    return NotImplementedError(f"{what} is not ported to "
                               f"tinympc_julia_tpu_torch yet ({item})")


from . import condensed, riccati  # noqa: E402,F401
