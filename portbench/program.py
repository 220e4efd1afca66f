"""The system under test: ``rwrt_tpu_torch``, driven as a user drives it.

``Program`` prepares the basic states once (what a user's process keeps
between runs) and serves one request per call: the cell's ``trace_rays``
(or ``trace_rays_ensemble``) over the prepared states, the sources handed
over as fresh host arrays. Nothing else of the package is read but its
outputs, its ``stats`` and its launch counters.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from portbench.inputs import Inputs

FIELDS = ("lon", "lat", "kx", "ky", "amp", "ug", "vg")


class Output(NamedTuple):
    """One request's result, flattened over the lanes: ``fields`` the seven
    trajectory fields, each (nt, R) with the members side by side
    (member-major, as views of each member's output where there is one
    member), ``lane_att`` (n_groups, R') the step attempts of the
    integrated lanes (adaptive runs), else None."""

    fields: List[List[torch.Tensor]]
    lane_att: Optional[torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


class Program:
    """The port over one cell's configuration and inputs on ``device``."""

    def __init__(self, config: dict, traffic: dict, inputs: Inputs,
                 device):
        import rwrt_tpu_torch as rt

        self.rt = rt
        self.run_config = rt.RunConfig(**config["run"])
        self.run_config.validate()
        self.request_kind = traffic["request"]
        if self.request_kind not in ("trace_rays", "trace_rays_ensemble"):
            raise ValueError(f"unknown request {self.request_kind!r}")
        self.inputs = inputs
        cal = dtype_of(self.run_config.cal_dtype)
        read = dtype_of(self.run_config.read_dtype)
        self.states = []
        for w in inputs.winds:
            if w.frame_dt is None:
                bs = rt.prepare(w.u, w.v, w.lat, w.lon, read_dtype=read,
                                cal_dtype=cal, device=device)
            else:
                bs = rt.prepare_time_varying(
                    w.u, w.v, w.lat, w.lon, bg_t0=0.0, bg_dt=w.frame_dt,
                    read_dtype=read, cal_dtype=cal, device=device)
            self.states.append(bs)
        if self.request_kind == "trace_rays" and len(self.states) != 1:
            raise ValueError("a trace_rays request takes one member")

    def sources(self):
        """The sources as fresh host arrays."""
        return dict(source_lon=np.array(self.inputs.source_lon),
                    source_lat=np.array(self.inputs.source_lat))

    def request(self) -> Output:
        """One request, returned without waiting for the card."""
        stats = {}
        if self.request_kind == "trace_rays":
            trajs = [self.rt.trace_rays(self.states[0], self.run_config,
                                        stats=stats, **self.sources())]
        else:
            trajs = self.rt.trace_rays_ensemble(
                self.states, self.run_config, stats=stats, **self.sources())
        nt = self.run_config.nt
        fields = [[getattr(t, f).reshape(nt, -1) for t in trajs]
                  for f in FIELDS]
        return Output(fields, stats.get("lane_att"))

    def launches(self) -> dict:
        """The package's whole-run and entry-stage launch counters."""
        from rwrt_tpu_torch import tracer

        return {"dense_kernel": tracer.LAUNCHES,
                "rk4_kernel": tracer.RK4_LAUNCHES,
                "exact_kernel": tracer.EXACT_LAUNCHES,
                "entry_kernel": tracer.ENTRY_LAUNCHES}
