"""Command-line entry point: `python -m helios_tpu [-parameter_file ...]`.

The reference is run as `python helios.py` with param.dat + ~70 CL
overrides (helios.py:140-145); this mirrors that surface."""

from __future__ import annotations

import os
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv

    from helios_tpu.compile_cache import enable_compile_cache
    from helios_tpu.config import config_from_cli
    from helios_tpu import pipeline

    enable_compile_cache()
    cfg_raw = config_from_cli(argv, finalize=False)
    if cfg_raw.planet_ensemble_file:
        # planet-ensemble mode: one batched device program for N planets
        # (the data-parallel axis the single-GPU reference lacks,
        # SURVEY.md section 2.4)
        from helios_tpu.parallel import ensemble as ens

        rows = ens.parse_ensemble_file(cfg_raw.planet_ensemble_file)
        cfgs = ens.configs_from_ensemble(cfg_raw, rows)
        outs = ens.run_ensemble(cfgs)
        print(f"\nDone! Ensemble of {len(outs)} planets finished in "
              f"{outs[0].wall_seconds:.1f} s.")
        for o in outs:
            state = o.conv if o.conv is not None else o.rad
            print(f"  {o.result.name}: {int(state.it)} iterations -> "
                  f"{o.result.out}")
        return 0
    cfg = cfg_raw.finalize()

    out = pipeline.run(cfg)
    r = out.result
    state = out.conv if out.conv is not None else out.rad
    print(f"\nDone! Run '{cfg.name}' finished in {out.wall_seconds:.1f} s "
          f"({int(state.it)} iterations).")
    if not cfg.singlewalk:
        from helios_tpu import host_physics as hp
        imbalance = hp.global_energy_balance(
            r.F_net, r.F_add_heat_sum, r.F_smooth_sum, r.F_intern,
            r.F_down_tot[r.nlayer])
        print(f"Global energy imbalance: {imbalance * 1e6:.3f} ppm")
    print(f"Output written to {r.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
