"""A ``torch.profiler`` trace of N warm training steps of a ladder config.

The port's counterpart of the JAX package's ``tools/trace_ladder.py``: the
step, batch and weights of ``tools/bench_ladder.py``'s configuration, three
warm-up steps, then ``--steps`` steps traced with the CPU and CUDA
activities, shapes and Python stacks, written as a Chrome trace to
``<logdir>/trace.json``. A trace that comes back without device records
(seen now and then on an H100) is taken again.

    python -m protein_transformer_tpu_torch.tools.trace_ladder \\
        --config 5 --dtype bfloat16 --steps 10
    python -m protein_transformer_tpu_torch.tools.analyze_trace \\
        <logdir> --by source --steps 10

The default ``--logdir`` is ``torch_trace_ladder`` under the temporary
directory. ``--device cpu`` traces the CPU operations alone (tests only);
without it the tool needs a GPU and raises when there is none.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.tools.bench_drmsd_kernel import traced
from protein_transformer_tpu_torch.tools.bench_ladder import (
    LADDER, ladder_batch, ladder_config, ladder_trainer, synchronizer)
from protein_transformer_tpu_torch.utils import TRACE_FILE

WARM_STEPS = 3


def trace_steps(step, steps: int, path: str, on_card: bool) -> int:
    """Trace ``steps`` calls of step() into the Chrome trace ``path``;
    returns the traces taken (``bench_drmsd_kernel.traced``: on the card a
    trace without device records is taken again)."""
    prof, taken = traced(step, steps, on_card, record_shapes=True,
                         with_stack=True)
    prof.export_chrome_trace(path)
    return taken


def trace_config(idx: int, steps: int, logdir: str, dtype: str = "bfloat16",
                 b: int | None = None, device: torch.device | None = None
                 ) -> str:
    """Trace ``steps`` warm steps of ladder entry ``idx``; returns the
    trace's path."""
    device = torch.device(device) if device is not None else cuda_device()
    b = b or LADDER[idx]["b"]
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = ladder_config(idx, b, out_dir, dtype, name=f"trace{idx}")
        trainer = ladder_trainer(cfg, device)
        state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
        batch = ladder_batch(trainer, b)
        sync = synchronizer(device)

        def step():
            nonlocal state
            state = trainer.train_step(state, batch)[0]

        for _ in range(WARM_STEPS):
            step()
        sync()
        trace_steps(step, steps, path, device.type == "cuda")
    return path


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", type=int, default=5, choices=sorted(LADDER))
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--logdir", default=os.path.join(tempfile.gettempdir(),
                                                     "torch_trace_ladder"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu traces the CPU operations alone (tests only)")
    args = ap.parse_args(argv)
    device = (cuda_device() if args.device == "cuda"
              else torch.device("cpu"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = trace_config(args.config, args.steps, args.logdir, args.dtype,
                        args.batch, device)
    print(f"trace written to {path} ({args.steps} steps)")
    return path


if __name__ == "__main__":
    main()
