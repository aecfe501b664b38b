"""Checkpoint / resume of the solver state (counterpart of
``lrs_pnp_dip_tpu/utils/checkpoint.py``, on ``torch.save`` in place of orbax).

Every outer iteration's ``SolverState`` (X, the duals, the generator that
draws the DIP inits, the counter) can be saved and restored; with the
deterministic step this gives exact resume.  A checkpoint is one file,
``step_<n>.pt``, holding only tensors, strings and integers, and it is read
back with ``torch.load(weights_only=True)``.

:func:`pytree_to_state` carries a state across from the JAX package (its
``state_to_pytree`` dict of numpy arrays), as ``params_from_flax`` carries
weights, and :func:`state_to_pytree` carries one back.
"""

from __future__ import annotations

import os
import re
from typing import Mapping, Optional

import numpy as np
import torch

from ..solvers.admm import SolverState
from .device import resolve_device

_NAME = re.compile(r"^step_(\d+)\.pt$")


class SolverCheckpointer:
    """Save/restore SolverState keyed by outer-iteration number, keeping the
    newest ``max_to_keep`` checkpoints."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> list:
        found = (_NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: SolverState) -> None:
        record = {
            "X": state.X.detach().cpu(),
            "lambda1": state.lambda1.detach().cpu(),
            "lambda2": state.lambda2.detach().cpu(),
            "itr": int(state.itr),
            "generator_state": state.generator.get_state(),
            "generator_device": state.generator.device.type,
        }
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(record, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device="cuda") -> Optional[SolverState]:
        """The state saved at ``step`` (default: the latest; None if there
        is none) on ``device``: the card by default, which raises when there
        is none.  The generator is made on ``device`` in the saved state, so
        it must be of the saved generator's kind (a CUDA generator's state
        cannot seed a CPU one, nor the reverse)."""
        dev = resolve_device(device)
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        record = torch.load(self._path(step), map_location="cpu", weights_only=True)
        if record["generator_device"] != dev.type:
            raise ValueError(
                f"the checkpoint holds a {record['generator_device']} generator; "
                f"restore it on a {record['generator_device']} device, not {dev}"
            )
        generator = torch.Generator(device=dev)
        generator.set_state(record["generator_state"])
        return SolverState(
            X=record["X"].to(dev),
            lambda1=record["lambda1"].to(dev),
            lambda2=record["lambda2"].to(dev),
            generator=generator,
            itr=record["itr"],
        )

    def close(self):
        """Nothing to release: every save is written and closed at once."""


def state_to_pytree(state: SolverState, key) -> dict:
    """The state in the JAX package's checkpoint layout (its
    ``state_to_pytree``): a dict of numpy arrays ``X``, ``lambda1``,
    ``lambda2``, ``key`` and ``itr``, which the JAX package's
    ``pytree_to_state`` resumes.  The torch generator does not carry across:
    ``key`` is the caller's JAX PRNG key as raw uint32 data (for example
    ``np.asarray(jax.random.PRNGKey(seed))``)."""
    return {
        "X": state.X.detach().cpu().numpy(),
        "lambda1": state.lambda1.detach().cpu().numpy(),
        "lambda2": state.lambda2.detach().cpu().numpy(),
        "key": np.asarray(key, np.uint32),
        "itr": np.asarray(state.itr, np.int32),
    }


def pytree_to_state(tree: Mapping[str, np.ndarray], generator: torch.Generator) -> SolverState:
    """The port's SolverState from the dict of numpy arrays that the JAX
    package's ``state_to_pytree`` writes.  The JAX PRNG key does not carry
    across, so the caller gives the generator, and the state lives on the
    generator's device."""
    dev = generator.device

    def tensor(k):
        return torch.as_tensor(np.asarray(tree[k], np.float32), device=dev)

    return SolverState(
        X=tensor("X"), lambda1=tensor("lambda1"), lambda2=tensor("lambda2"),
        generator=generator, itr=int(tree["itr"]),
    )


state_from_jax_pytree = pytree_to_state  # the name it had before pytree_to_state
