"""Mesh shape arithmetic (a copy of ``parallel/mesh.py``'s
``enumerate_mesh_shapes`` and ``mesh_shape_for``): which (data, pipe,
model) factorizations of a device count are candidates.  Constructing a
mesh waits for ROADMAP.md queue 1's 'Parallel and training'."""

from __future__ import annotations

from typing import Optional, Tuple


def enumerate_mesh_shapes(
    n_devices: int,
    max_model: Optional[int] = None,
    max_pipe: int = 1,
) -> Tuple[Tuple[int, int, int], ...]:
    """Every (data, pipe, model) factorization of ``n_devices`` (seq=1),
    each satisfying ``data * pipe * model == n_devices``.
    ``max_model``/``max_pipe`` bound the model/pipe degrees; shapes are
    ordered data-major (pure data parallelism first)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    shapes = []
    for pipe in range(1, max(1, max_pipe) + 1):
        if n_devices % pipe:
            continue
        rem = n_devices // pipe
        for model in range(1, rem + 1):
            if rem % model:
                continue
            if max_model is not None and model > max_model:
                continue
            shapes.append((rem // model, pipe, model))
    return tuple(sorted(set(shapes), key=lambda s: (-s[0], s[1], s[2])))


def mesh_shape_for(n_devices: int, want_model: int = 1,
                   want_seq: int = 1) -> Tuple[int, int, int]:
    """Largest data axis given desired model/seq parallelism, shrinking model
    then seq until they divide the device count."""
    model, seq = want_model, want_seq
    while n_devices % (model * seq) and model > 1:
        model //= 2
    while n_devices % (model * seq) and seq > 1:
        seq //= 2
    return n_devices // (model * seq), model, seq
