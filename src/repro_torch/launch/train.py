"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the fault-tolerant ``Trainer`` on synthetic batches shaped by the
arch's train step (``models/testing.dummy_batch``: every id 0, floats
N(0, 1), masks all true; batch i of a run drawn with seed i). It runs on
the ``cuda`` card unless ``--device cpu`` says otherwise (no card: it
raises); the smoke-size config is the default, ``--full`` the full one.
A second run on the same ``--ckpt-dir`` resumes from its latest
checkpoint; without ``--ckpt-dir`` a run checkpoints into a new directory
under the temp dir (printed first) and starts fresh.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="train shape name")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="full-width config instead of smoke")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; resumes from its latest checkpoint "
                         "(default: a new directory under the temp dir)")
    ap.add_argument("--ckpt-interval", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0,
                    help="the params' init seed (a fresh run only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from repro_torch.kernels.common import resolve_device
    from repro_torch.models.api import get_arch
    from repro_torch.models.testing import dummy_batch
    from repro_torch.train.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    arch = get_arch(args.arch, smoke=not args.full)
    shape = args.shape or next(n for n, s in arch.shapes.items()
                               if s.kind == "train")
    spec = arch.step(shape)

    def data_iter():
        i = 0
        while True:
            i += 1
            yield dummy_batch(spec.input_specs, seed=i, device=device)

    tr = Trainer(arch, TrainerConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_interval=args.ckpt_interval, log_interval=10), device=device)
    print("checkpoints in", tr.cfg.ckpt_dir)
    state, meta = tr.resume_or_init(args.seed)
    state, hist = tr.fit(data_iter(), state, int(meta.get("step", 0)))
    for step, m in hist:
        print(f"step {step}: loss={m.get('loss'):.4f} "
              f"({m.get('steps_per_sec', 0):.2f} steps/s)")
    print("final checkpoint:", tr.ckpt.latest_step())


if __name__ == "__main__":
    main()
