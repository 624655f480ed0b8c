"""The route rule: the one place a codec call picks its implementation.

Every codec writes the same container on every route:
  - None:     the platform's route. On a GPU that is the codec's hand-written
              kernel where it has one and the shape is one the kernel takes;
              everywhere else the XLA twin.
  - "jax":    the plain XLA twin (ops/*), the reference on the card.
  - "ref":    the host oracle (reference/*).
  - "native": the host C++ codec (SLZ4 only; codecs/slz4.py).

A kernel route that cannot run (library missing, build failing) raises; it
never gives way to another route.
"""

from __future__ import annotations


def platform() -> str:
    import jax

    return jax.devices()[0].platform


def pick_backend(backend: str | None, jax_fn, ref_fn, kernel_fn=None,
                 kernel_takes: bool = False):
    if backend is None:
        if kernel_fn is not None and kernel_takes and platform() == "gpu":
            return kernel_fn
        return jax_fn if jax_fn is not None else ref_fn
    if backend == "jax":
        return jax_fn if jax_fn is not None else ref_fn
    if backend == "ref":
        return ref_fn
    raise ValueError(f"unknown backend {backend!r}")
