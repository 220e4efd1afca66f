"""Command-line entry point: python -m rwrt_tpu_torch --config run.json

The JSON config maps 1:1 onto RunConfig fields plus the three file paths
(inputuv / bsfile / ncfile), as for ``python -m rwrt_tpu``; keys starting
with "_" are comments. The run goes to the card; ``--device cpu`` runs it
on the host; ``--mesh`` splits the rays over a mesh of the run's devices
(RunConfig.mesh_devices of them; default every card, or one entry of the
CPU).
"""

import argparse
import dataclasses
import json
import sys

from rwrt_tpu_torch.config import RunConfig
from rwrt_tpu_torch.main import RunPaths, run


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="rwrt_tpu_torch",
        description="Rossby wave ray tracing on a CUDA card (PyTorch port)"
    )
    ap.add_argument("--config", required=True, help="JSON config file")
    ap.add_argument("--mesh", action="store_true",
                    help="shard rays over a mesh of the run's devices "
                         "(mesh_devices of them; default: every card)")
    ap.add_argument("--chunked", action="store_true",
                    help="chunked driver with progress reporting")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file for resumable runs")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write a machine-readable JSON run report (config "
                         "echo, versions and device, phase wall-clock, "
                         "per-ray termination accounting)")
    ap.add_argument("--report-exact", action="store_true",
                    help="exact death causes in the report "
                         "(termination.classify re-runs each killing "
                         "interval in one batch)")
    ap.add_argument("--wnmaps", default=None, metavar="PATH",
                    help="also compute and write the grid-wide wavenumber "
                         "diagnostics (stationary/non-stationary m-roots, "
                         "rootnum, group velocities, Ks) for the configured "
                         "zwn set")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the run goes (default: the CUDA card; a "
                         "run on a machine without one is an error)")
    args = ap.parse_args(argv)

    with open(args.config) as f:
        raw = json.load(f)
    # keys starting with "_" are comments (JSON has no comment syntax)
    raw = {k: v for k, v in raw.items() if not k.startswith("_")}

    if "inputuv" not in raw:
        ap.error(f"{args.config}: missing required key 'inputuv'")
    paths = RunPaths(
        inputuv=raw.pop("inputuv"),
        bsfile=raw.pop("bsfile", None),
        ncfile=raw.pop("ncfile", None),
    )
    valid = {f.name for f in dataclasses.fields(RunConfig)}
    unknown = sorted(set(raw) - valid)
    if unknown:
        ap.error(
            f"{args.config}: unknown config key(s) {unknown}; valid keys are "
            f"inputuv/bsfile/ncfile and {sorted(valid)}"
        )
    cfg = RunConfig(**raw)

    # --wnmaps rides the same run: the maps come from the basic state run()
    # already prepared.
    run(cfg, paths, mesh=True if args.mesh else None, chunked=args.chunked,
        checkpoint_path=args.checkpoint, wnmaps_path=args.wnmaps,
        report_path=args.report, report_exact_causes=args.report_exact,
        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
