"""Plot ray trajectories (and optionally a WRF flux map) from output files,
through the PyTorch/CUDA port's reader (``plot_trajectories.py`` on
``rwrt_tpu``).

Counterpart of the manual's plotting script ("the Great Circle plot.py",
referenced by manual section 2 but absent from the reference snapshot):
reads a trajectory file written by write_trajectories (either package's)
and draws the ray paths on a lon-lat map, colored by initial zonal
wavenumber, with dead segments ending where the rays terminated. Reading
and drawing run on the host; ``--device`` is taken as the other examples
take it (cuda, the default, needs a card).

    PYTHONPATH=. python examples/torch_plot_trajectories.py traj.npz rays.png
    PYTHONPATH=. python examples/torch_plot_trajectories.py traj.npz rays.png \\
        wrf.npz --device cpu
"""

import argparse

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from rwrt_tpu_torch.io import ncio  # noqa: E402
from rwrt_tpu_torch.main import add_device_option, run_device  # noqa: E402


def plot(traj_path, out_png, flux_path=None):
    d = ncio.load_trajectories(traj_path)
    rlon, rlat, rzwn = d["rlon"], d["rlat"], d["rzwn"]
    nt, nroot, nsource, nzwn = rlon.shape

    fig, ax = plt.subplots(figsize=(12, 6), dpi=120)
    cmap = plt.get_cmap("viridis", max(nzwn, 2))
    for z in range(nzwn):
        color = cmap(z)
        for s in range(nsource):
            for r in range(nroot):
                lon = rlon[:, r, s, z]
                lat = rlat[:, r, s, z]
                ok = np.isfinite(lon) & np.isfinite(lat)
                if ok.sum() < 2:
                    continue
                # split at dateline wraps so lines don't streak across
                lo = lon[ok] % 360.0
                la = lat[ok]
                jump = np.abs(np.diff(lo)) > 180.0
                seg = np.split(np.arange(lo.size), np.where(jump)[0] + 1)
                for idx in seg:
                    if idx.size > 1:
                        ax.plot(lo[idx], la[idx], color=color, lw=0.6,
                                alpha=0.7)
        k0 = rzwn[0, :, :, z]
        k0 = k0[np.isfinite(k0)]
        label = f"k={k0[0]:.0f}" if k0.size else f"zwn[{z}]"
        ax.plot([], [], color=color, lw=2, label=label)

    if flux_path:
        with np.load(flux_path) as f:
            lon_c, lat_c = f["lon"], f["lat"]
            mag = np.hypot(f["flux_u"], f["flux_v"])
        # central circle of the -360..720 scope
        keep = (lon_c >= 0.0) & (lon_c < 360.0)
        ax.contourf(lon_c[keep], lat_c, mag[keep].T, levels=12,
                    cmap="Reds", alpha=0.35)

    ax.set_xlim(0, 360)
    ax.set_ylim(-90, 90)
    ax.set_xlabel("longitude (deg E)")
    ax.set_ylabel("latitude (deg N)")
    ax.set_title("Rossby wave ray trajectories")
    ax.grid(alpha=0.3)
    ax.legend(loc="lower right", fontsize=8, ncol=4)
    fig.tight_layout()
    fig.savefig(out_png)
    print(f"wrote {out_png}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("traj")
    ap.add_argument("out_png")
    ap.add_argument("flux", nargs="?", default=None)
    add_device_option(ap)
    args = ap.parse_args(argv)
    run_device(args.device)
    plot(args.traj, args.out_png, args.flux)


if __name__ == "__main__":
    main()
