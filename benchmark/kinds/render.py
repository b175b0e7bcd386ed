"""The ``render`` kind: the CLI ``render`` user's band loop.

``render_rows`` over bands of ``rays_per_chunk // (width · spp_chunk)``
rows at ``spp`` samples in chunks of ``spp_chunk``, each band ending with
its ``.cpu()`` copy; bands cycle over the frame, frame ``f`` keyed
``frame_key(seed, f)``.  Set-up renders one wavefront of the first band.

The check renders again ``checked_bands`` of the window's bands, drawn
from the seed among the frames' middle bands, with the reference: the
limit was set on the middle band, and the top band sees the sky alone,
where every sample reads alike.  Where the window closes before a frame's
middle band, the loop goes on, untimed, to the first one.  The traced
segment renders one middle band; its unprofiled wall is the median of
three unprofiled runs of the same band.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from benchmark import compare, drivers, inputs
from benchmark.reference import scene as rscene
from benchmark.reference import tracer


class Driver(drivers.Driver):
    unit_name, grad = "band", False

    def setup(self):
        from ptx_torch.integrate.render import render_rows

        self.build()
        t = self.traffic
        self.spp, self.spp_chunk = int(t["spp"]), int(t["spp_chunk"])
        self.rows = int(t["rays_per_chunk"]) // (self.width * self.spp_chunk)
        if self.rows < 1 or self.height % self.rows or self.spp % self.spp_chunk:
            raise ValueError("the mix's band must divide the frame and its chunk the spp")
        self.per_frame = self.height // self.rows
        self.middle = self.per_frame // 2
        self.n_chunks = self.spp // self.spp_chunk
        self.lanes = self.rows * self.width * self.spp_chunk
        self.render_rows = render_rows
        with torch.no_grad():
            render_rows(self.scene, self.scene.params, self.cam,
                        inputs.frame_key(self.seed, -1), 0, self.rows, self.spp_chunk, 1,
                        self.depth).cpu()
        self.bands, self.j = [], 0

    def band(self, j):
        """Band ``j`` of the loop: its frame's key and its first row."""
        f, y0 = j // self.per_frame, (j % self.per_frame) * self.rows
        return inputs.frame_key(self.seed, f), y0

    def _one(self, j=None):
        """Band ``j``, or the loop's next band."""
        if j is None:
            j, self.j = self.j, self.j + 1
        key, y0 = self.band(j)
        with torch.no_grad():
            band = self.render_rows(self.scene, self.scene.params, self.cam, key, y0,
                                    self.rows, self.spp_chunk, self.n_chunks,
                                    self.depth).cpu()
        return band

    def window(self, seconds):
        times = []
        t0 = t1 = time.perf_counter()
        while t1 - t0 < seconds:
            self.bands.append(self._one())
            times.append(time.perf_counter() - t1)
            t1 += times[-1]
        wall = t1 - t0
        n = len(self.bands)
        rays = n * self.rows * self.width * self.spp * (self.depth + 1)
        failed = sum(not bool(torch.isfinite(b).all()) for b in self.bands)
        while len(self.bands) <= self.middle:
            self.bands.append(self._one())
        return {"attempted": n, "failed": failed, "unit_s": times,
                "metrics": {"render_mrays_per_s": rays / wall / 1e6}}

    def before_profile(self):
        self.traced = (self.j // self.per_frame + 1) * self.per_frame + self.middle
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            self._one(self.traced)
            walls.append(time.perf_counter() - t0)
        self.unit_wall_ms = statistics.median(walls) * 1e3 / self.n_chunks

    def profile_units(self):
        self._one(self.traced)
        return self.n_chunks

    def release(self):
        del self.scene

    def check(self):
        rs = self.ref_scene()
        P = rscene.params(rs, self.device)
        middles = [j for j in range(len(self.bands)) if j % self.per_frame == self.middle]
        n = min(int(self.traffic["checked_bands"]), len(middles))
        worst = 0.0
        for j in sorted(random.Random(self.seed).sample(middles, n)):
            key, y0 = self.band(j)
            ref = tracer.render_rows(rs, P, key, y0, self.rows, self.spp_chunk,
                                     self.n_chunks, self.depth, self.device)
            worst = max(worst, compare.band_gap(self.bands[j], ref.cpu()))
        return {"band_gap": worst}


def controls(drv) -> dict:
    """On frame 0's middle band: the control (the reference in bfloat16 in
    the program's place) and the fault of half the batch (the first half
    of the band's wavefronts, the mean taken over them), each judged
    against the reference in float32."""
    rs = drv.ref_scene()
    P = rscene.params(rs, drv.device)
    key, y0 = drv.band(drv.middle)
    args = (drv.rows, drv.spp_chunk)
    full = tracer.render_rows(rs, P, key, y0, *args, drv.n_chunks, drv.depth, drv.device)
    Pl = rscene.params(rs, drv.device, torch.bfloat16)
    low = tracer.render_rows(rs, Pl, key, y0, *args, drv.n_chunks, drv.depth, drv.device,
                             torch.bfloat16)
    half = tracer.render_rows(rs, P, key, y0, *args, drv.n_chunks // 2, drv.depth,
                              drv.device)
    return {"control": {"band_gap": compare.band_gap(low.float().cpu(), full.cpu())},
            "half_batch": {"band_gap": compare.band_gap(half.cpu(), full.cpu())}}
