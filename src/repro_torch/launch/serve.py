"""Serving launcher: batched prefill + greedy decode with a decode cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --batch 8 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --batch 8 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --batch 8 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --batch 8 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-72b \
        --smoke --device cpu

Port of ``repro/launch/serve.py``: cache construction, batched prefill and
the decode hot loop.  The hand kernels on the path depend on the family
(``PATH_KERNELS``): the decode attention of a dense, vlm, moe or hybrid
model is ``decode_attn`` (a hybrid model's shared attention block, once a
group); an ssm (rwkv6) model's WKV recurrence is ``wkv``, on prefill and
on every decode step.  A vlm prompt carries the synthetic pipeline's
vision rows and (B, S, 3) M-RoPE positions.  qwen2-vl-72b (145 GB in
bf16) does not fit one card at full depth.  Weights are random, made from
``--seed``.  Runs on the card unless ``--device cpu`` is given; with no
card, ``--device cuda`` raises.
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.kernels import build, decode_attn, rwkv_wkv
from repro_torch.models.config import smoke_variant
from repro_torch.models.model import Model

#: The hand kernels each ported family's serving path launches.
PATH_KERNELS = {"dense": {"decode_attn": decode_attn.KERNEL},
                "vlm": {"decode_attn": decode_attn.KERNEL},
                "moe": {"decode_attn": decode_attn.KERNEL},
                "hybrid": {"decode_attn": decode_attn.KERNEL},
                "ssm": {"wkv": rwkv_wkv.KERNEL}}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    model = Model(cfg, device=args.device)
    dev = model.device
    params = model.init(args.seed)
    print(f"[serve] arch={cfg.name} params={model.param_count():,} "
          f"device={dev} dtype={cfg.dtype}")
    if dev.type == "cuda":
        # Build (or load) the path's kernels before any clock starts.
        kernels = PATH_KERNELS[cfg.family]
        t0 = time.time()
        build.load_all([kern.library for kern in kernels.values()])
        for name, kern in kernels.items():
            kern.fn()
            print(f"[serve] {name} kernel ready in "
                  f"{(time.time() - t0) * 1e3:.1f} ms")

    ds = SyntheticDataset(cfg, args.batch, args.prompt_len,
                          seed=args.seed + 1)
    batch = ds.batch_at(0)
    prompt = {k: v for k, v in batch.items()
              if k not in ("targets", "loss_mask")}

    with torch.inference_mode():
        cache = model.make_cache(args.batch, args.prompt_len + args.gen)
        _sync(dev)
        t0 = time.time()
        logits, cache = model.prefill(params, prompt, cache)
        _sync(dev)
        t_prefill = time.time() - t0
        del cache

        t0 = time.time()
        toks, cache = model.greedy_generate(params, prompt, model.make_cache(
            args.batch, args.prompt_len + args.gen), steps=args.gen)
        toks = toks.cpu().numpy()
        t_gen = time.time() - t0

    tok_s = args.batch * args.gen / max(t_gen, 1e-9)
    print(f"[serve] prefill {args.batch}x{args.prompt_len} tokens: "
          f"{t_prefill*1e3:.1f} ms")
    print(f"[serve] decode {args.gen} steps (greedy_generate: prefill again "
          f"+ {args.gen} steps): {t_gen*1e3:.1f} ms "
          f"({tok_s:.1f} tok/s, batch {args.batch})")
    print(f"[serve] sample continuation (batch 0): {toks[0][:16].tolist()}")
    return toks


if __name__ == "__main__":
    main()
