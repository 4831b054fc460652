"""Replicated-index data parallelism.

The reference's only parallelism is N worker threads pulling read batches
from a mutex-guarded queue against one shared in-memory index
(main.cpp:219-223). The device equivalent: the index lives replicated in
every device's memory (zero collectives on the probe path) and each batch
is sharded over the mesh's data axis; XLA partitions the whole classify
kernel with no communication, so the kernel scales with devices (host
ingest is shared; ROADMAP Reach 5).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from shark_tpu.classify.step import Classifier
from shark_tpu.index.structure import SharkIndex
from shark_tpu.parallel.mesh import make_mesh


class DataParallelClassifier(Classifier):
    """Classifier over a device mesh: index replicated, batch axis sharded
    over "dp". Construction (device-index build, hashed/classic probe
    selection, threshold tables, kernel cache) is inherited from Classifier
    so the single-device and data-parallel paths can never diverge — only
    array placement and jit shardings differ."""

    def __init__(
        self,
        index: SharkIndex,
        max_winners: int = 16,
        c: float = 0.6,
        n_devices: int = 0,
        mesh=None,
        probe=None,
        probe_opts=None,
    ):
        self.mesh = mesh or make_mesh(n_devices)
        self.n_devices = int(
            np.prod([self.mesh.shape[a] for a in self.mesh.axis_names])
        )
        self._repl = NamedSharding(self.mesh, P())
        self._batch = NamedSharding(self.mesh, P("dp"))
        # device_put accepts a Sharding wherever it accepts a Device, so
        # the replicated spec rides the base constructor's placement
        super().__init__(
            index, max_winners=max_winners, c=c, device=self._repl,
            probe=probe, probe_opts=probe_opts,
        )

    def _jit(self, kern, packed: bool):
        data = (self._batch, self._batch) if packed else (self._batch,)
        dix_spec = jax.tree.map(lambda _: self._repl, self.dix)
        return jax.jit(
            kern,
            in_shardings=(dix_spec, self._repl) + data,
            out_shardings=(self._batch,) * 4,
        )

    def _check_b(self, B: int):
        if B % self.n_devices != 0:
            raise ValueError(
                f"batch size {B} not divisible by {self.n_devices} devices"
            )

    def __call__(self, codes: np.ndarray):
        self._check_b(codes.shape[0])
        return super().__call__(codes)

    def call_packed(self, packed: np.ndarray, vmask: np.ndarray):
        self._check_b(packed.shape[0])
        return super().call_packed(packed, vmask)
