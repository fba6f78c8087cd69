"""Named random draws for the generator.

The JAX generator draws from split PRNG keys; the port draws from a
`torch.Generator`. The two never give the same numbers, so every random
function of the port takes a `Draws`: a draw named in `given` is used as
given (tests hand in the JAX side's draws this way), any other is taken
fresh from the generator. Every draw used is stored in `record` under its
name, so a run can be replayed elsewhere with `given=record`.
"""

from __future__ import annotations

import numpy as np
import torch


def to_tensor(v, dtype, device):
    """An injected value (tensor, numpy array or number) as a tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(v), dtype=dtype, device=device)


class Draws:
    def __init__(self, generator=None, device="cpu", given=None, record=None):
        self.generator = generator
        self.device = torch.device(device)
        self.given = given or {}
        self.record = {} if record is None else record

    def _use(self, name, shape, dtype, fresh):
        v = self.given.get(name)
        if v is None:
            t = fresh()
        else:
            t = to_tensor(v, dtype, self.device)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"draw {name!r}: shape {tuple(t.shape)}, "
                                 f"expected {tuple(shape)}")
        self.record[name] = t
        return t

    def uniform(self, name, shape=()):
        """U[0, 1) float32."""
        return self._use(name, shape, torch.float32, lambda: torch.rand(
            shape, generator=self.generator, device=self.device))

    def normal(self, name, shape=()):
        """N(0, 1) float32."""
        return self._use(name, shape, torch.float32, lambda: torch.randn(
            shape, generator=self.generator, device=self.device))

    def randint(self, name, low, high, shape=()):
        """Integers in [low, high), int64."""
        return self._use(name, shape, torch.int64, lambda: torch.randint(
            low, high, shape, generator=self.generator, device=self.device))

    def value(self, name):
        """An injected value (float or tensor) or None; recorded as given."""
        v = self.given.get(name)
        if v is not None:
            self.record[name] = v
        return v

    def sub(self, name, index=None) -> "Draws":
        """The draws of a sub-step (`given[name]`, or `given[name][index]`
        for one of a list of steps), recorded at the same place."""
        given = self.given.get(name)
        if index is None:
            rec = self.record.setdefault(name, {})
        else:
            given = given[index] if given else None
            lst = self.record.setdefault(name, [])
            lst.extend({} for _ in range(index + 1 - len(lst)))
            rec = lst[index]
        return Draws(self.generator, self.device, given, rec)
