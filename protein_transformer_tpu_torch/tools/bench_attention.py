"""Device time of the flash attention's backward and of a flash training
step, on one GPU.

Times the port whose ``protein_transformer_tpu_torch`` this imports. Run as
a script with another checkout's root first on ``PYTHONPATH`` it times that
checkout's kernels instead, so that two versions can be compared in one
session on one card:

* at (B, H, L, D) = (8, 8, 256, 64), the eval and predict batches',
  (16, 8, 256, 64), the flash training step's, and (8, 8, 500, 64), the
  longest proteins, on the inputs of phase 8 of ``chip_smoke.py``
  (head-split views, q three times wider than k, ragged valid lengths, one
  batch row with no valid key), and at (16, 8, 256, 64) with the training
  batches' mask (15 full rows and one with no valid key): the device time
  of K3a without and with the row statistics m and l (as eval and predict,
  and as training call it), of the library's forward
  (``scaled_dot_product_attention`` with the same mask, a yardstick that
  the port never calls), of the backward that autograd runs through
  ``FlashSelfAttention`` (every kernel it puts on the device) and of
  autograd's backward through the library call; where the port has the one
  backward kernel, also that kernel asked for dQ alone and for dK, dV
  alone; each from a ``torch.profiler`` trace of five calls;
* the flagship conv-enc training step at dropout 0 with flash attention
  (d_model 512, 8 heads, 6 layers, batches of 15 proteins of length 255-256
  padded to B=16 x L=256, random seeded weights): device operations and
  device ms per step, from a trace of three steps.

    python -m protein_transformer_tpu_torch.tools.bench_attention
    PYTHONPATH=<other checkout> python <this file>

``--dtype bfloat16`` times the bf16 instances instead: the same inputs
rounded to bf16, the library call on them, and the training step under
``compute_dtype="bfloat16"`` (a checkout without bf16 kernels raises).

Prints one line per measurement with the card's name and power limit, then
the results as one JSON object. Needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import tempfile

import numpy as np
import torch

from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.ops import attention as A
from protein_transformer_tpu_torch.tools.bench_drmsd_kernel import (
    card_label, device_ms, device_records)
from protein_transformer_tpu_torch.training.trainer import Trainer

# (B, H, L, D), mask: "ragged" as phase 8 of chip_smoke.py draws it, or
# "train", the training batches' (15 full rows, one with no valid key)
CASES = (((8, 8, 256, 64), "ragged"), ((16, 8, 256, 64), "ragged"),
         ((8, 8, 500, 64), "ragged"), ((16, 8, 256, 64), "train"))
MODEL = "conv-enc|21,11,3|1,1,1"


def attention_inputs(device, shape, seed, mask="ragged",
                     dtype=torch.float32):
    """q, k, v (head-split views in ``dtype``; standard deviations 3, 1,
    1), dO and the mask: ragged valid lengths, or with ``mask="train"``
    every row full; the first batch row full and the last with no valid
    key."""
    bsz, heads, length, dim = shape
    rng = np.random.default_rng(seed)
    q, k, v, d_out = (
        torch.from_numpy(rng.normal(0, gain, (bsz, length, heads * dim))
                         .astype(np.float32)).to(device, dtype)
        .reshape(bsz, length, heads, dim).transpose(1, 2)
        for gain in (3.0, 1.0, 1.0, 1.0))
    n_valid = (rng.integers(1, length + 1, bsz) if mask == "ragged"
               else np.full(bsz, length))
    n_valid[0] = length
    n_valid[-1] = 0
    valid = torch.from_numpy(
        np.arange(length)[None, :] < n_valid[:, None]).to(device)
    return q, k, v, d_out, valid


def kernel_name(key: str) -> str:
    """A profiler key without its namespace, template and parameters."""
    return re.split(r"[<(]", key.split("::", 1)[-1])[0].strip()


def attention_times(device, shape, mask, seed=0,
                    dtype=torch.float32) -> dict:
    """Device ms of K3a (without and with m and l), of the library's
    forward, of the backward through ``FlashSelfAttention`` and of the
    library's backward at one (B, H, L, D) and mask, the device operations
    of one backward and, with the one backward kernel, the device ms of each
    of its roles alone."""
    q, k, v, d_out, valid = attention_inputs(device, shape, seed, mask,
                                             dtype)
    scale = 1.0 / math.sqrt(shape[-1])
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = A.flash_self_attention(*leaves, valid, sm_scale=scale, impl="cuda")
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=valid[:, None, None, :], scale=scale)

    def backward(o):
        return lambda: torch.autograd.grad(o, leaves, d_out,
                                           retain_graph=True)

    calls = 5
    records = device_records(backward(out), calls)

    def library_forward():
        with torch.no_grad():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=valid[:, None, None, :], scale=scale)

    times = {
        "forward_device_ms": device_ms(
            lambda: A.flash_attn_fwd_cuda(q, k, v, valid, scale)),
        "forward_stats_device_ms": device_ms(
            lambda: A.flash_attn_fwd_cuda(q, k, v, valid, scale,
                                          with_stats=True)),
        "library_forward_device_ms": device_ms(library_forward),
        "backward_device_ms": device_ms(backward(out)),
        "backward_device_ops": sum(e.count for e in records) / calls,
        "backward_kernels": sorted({kernel_name(e.key) for e in records}),
        "library_backward_device_ms": device_ms(backward(lib_out))}
    if hasattr(A, "flash_attn_bwd_cuda"):
        _, m, l = A.flash_attn_fwd_cuda(q, k, v, valid, scale,
                                        with_stats=True)
        args = (q, k, v, valid, d_out, out.detach(), m, l, scale)
        times["dq_role_device_ms"] = device_ms(
            lambda: A.flash_attn_bwd_cuda(*args, want_dkv=False))
        times["dkv_role_device_ms"] = device_ms(
            lambda: A.flash_attn_bwd_cuda(*args, want_dq=False))
    return times


def train_step_profile(device, steps: int = 3,
                       compute_dtype: str = "float32") -> dict:
    """Device operations and device ms per flagship training step at
    dropout 0 with flash attention, computing in ``compute_dtype``."""
    data = make_dataset(n_train=16, n_eval=2, min_len=255, max_len=256,
                        seed=0, device=device)
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = TrainConfig(
            model=MODEL, d_model=512, d_ff=2048, n_heads=8, n_layers=6,
            loss="combined", optimizer="adam", lr_scheduling="noam",
            bucket_sizes=(256,), batch_size=8, max_seq_len=256, dropout=0.0,
            attention_impl="flash", drmsd_impl="cuda", sidechain_impl="cuda",
            log_structure_step=0, log_val_struct_step=0, out_dir=out_dir,
            name="bench-attention",
            **({} if compute_dtype == "float32"
               else {"compute_dtype": compute_dtype}))
        trainer = Trainer(cfg, device=device, data=data)
        gen = torch.Generator().manual_seed(0)
        params = trainer.init_params(gen)
        w = params["head.output_projection.weight"]
        params["head.output_projection.weight"] = (
            0.02 * torch.randn(w.shape, generator=gen)).to(device)
        state = trainer.state_from(params)
        batch = next(trainer.dm.train_batches(np.random.default_rng(0)))

        def step():
            nonlocal state
            state = trainer.train_step(state, batch)[0]

        step()
        on_device = device_records(step, steps)
    return {"batch": list(batch.seq.shape),
            "device_ops": sum(e.count for e in on_device) / steps,
            "device_ms": sum(e.self_device_time_total
                             for e in on_device) / 1e3 / steps}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="the kernel instance and the step's compute "
                             "dtype to time")
    args = parser.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    device = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_label()
    print(f"# port at {A.__file__}, {args.dtype}")
    results = {"card": card, "dtype": args.dtype, "attention": {}}
    for shape, mask in CASES:
        t = attention_times(device, shape, mask, dtype=dtype)
        results["attention"]["x".join(map(str, shape)) + " " + mask] = t
        roles = (f"; dQ role alone {t['dq_role_device_ms']:.4f} ms, dK/dV "
                 f"role alone {t['dkv_role_device_ms']:.4f} ms"
                 if "dq_role_device_ms" in t else "")
        print(f"attention {shape}, {mask} mask: K3a "
              f"{t['forward_device_ms']:.4f} ms ("
              f"{t['forward_stats_device_ms']:.4f} with m and l), library "
              f"forward {t['library_forward_device_ms']:.4f} ms, backward "
              f"{t['backward_device_ms']:.4f} ms "
              f"({t['backward_device_ops']:.0f} device operations: "
              f"{', '.join(t['backward_kernels'])}){roles}, library backward "
              f"{t['library_backward_device_ms']:.4f} ms, on the device "
              f"({card})")
    t = train_step_profile(device, compute_dtype=args.dtype)
    results["flash_train_step"] = t
    print(f"flash train step, B x L = {t['batch']}: "
          f"{t['device_ops']:.1f} device operations, "
          f"{t['device_ms']:.3f} ms of device time per step ({card})")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
