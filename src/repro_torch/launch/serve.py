"""Batched serving driver: prefill, then a decode loop with KV caches.

The counterpart of ``repro.launch.serve``, with the same flags plus
``--device`` (default ``cuda``; raises without a card) and ``--attn-impl``
(default: the config's own ``attn_impl``). Every family is served: vlm
prompts carry stub patch embeddings (their positions come first, so decode
starts at ``n_patches + P``), encdec prompts stub encoder frames. Under
``--attn-impl pallas`` prefill attention runs the flash kernel and the
decode of a non-windowed attention layer the decode kernel
(:mod:`repro_torch.kernels.ops`). On the CPU use ``--reduced``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --reduced --device cpu --temperature 0 --attn-impl pallas

The weights are random, drawn from a ``torch.Generator`` seeded with
``--seed``; the prompt tokens, then the patches or frames, come from
``np.random.default_rng(seed)``, as ``repro``'s. Sampling at a temperature above 0 uses ``torch.multinomial``,
not ``jax.random``'s stream (ROADMAP hazard H3).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.module import tree_map


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray  # (B, gen + 1): the prefill's token, then gen decoded
    prefill_s: float
    decode_s: float  # the whole decode loop

    def summary(self) -> str:
        B, n = self.tokens.shape
        gen = n - 1
        return (f"prefill: {self.prefill_s * 1e3:.1f} ms for {B} prompts; "
                f"decode: {self.decode_s / max(gen, 1) * 1e3:.2f} ms/token "
                f"({B * gen / self.decode_s if self.decode_s else 0.0:.1f} "
                f"tok/s)")


def _grow(full: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``c`` copied into the prefix of ``full`` along the one axis where
    their shapes differ (``repro``'s ``copy_prefix``); a cache of the same
    shape (encdec's cross K/V, recurrent states, ring buffers) is ``c``."""
    if full.shape == c.shape:
        return c
    axis = [i for i, (a, b) in enumerate(zip(full.shape, c.shape)) if a != b][0]
    full.narrow(axis, 0, c.shape[axis]).copy_(c)
    return full


def _pick(logits: torch.Tensor, vocab: int, temperature: float,
          gen: torch.Generator) -> torch.Tensor:
    logits = logits[:, :vocab]
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def prompt_inputs(cfg: ArchConfig, batch: int, prompt_len: int, seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """The prefill batch of :func:`serve`: ``batch`` random prompts of
    ``prompt_len`` tokens, then the vlm patches or encdec frames, all from
    ``np.random.default_rng(seed)`` in ``repro``'s order."""
    rng = np.random.default_rng(seed)
    inputs = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (batch, prompt_len)), dtype=torch.int32,
        device=device)}
    if cfg.family == "vlm":
        inputs["patches"] = torch.as_tensor(
            rng.normal(size=(batch, cfg.n_patches, cfg.d_model)),
            dtype=torch.float32, device=device)
    if cfg.family == "encdec":
        inputs["frames"] = torch.as_tensor(
            rng.normal(size=(batch, cfg.enc_frames, cfg.d_model)),
            dtype=torch.float32, device=device)
    return inputs


def position_offset(cfg: ArchConfig) -> int:
    """Where a prompt's text starts: after the vlm's patch prefix."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def serve(cfg: ArchConfig, *, batch: int, prompt_len: int, gen: int,
          temperature: float = 1.0, seed: int = 0, device="cuda",
          params: Optional[Dict] = None) -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens each. ``params`` defaults to random weights from
    ``init_model`` on a generator seeded with ``seed``. On the card each
    timer is read after a synchronize."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if params is None:
        params = api.init_model(torch.Generator(dev).manual_seed(seed), cfg)
    B, P = batch, prompt_len
    inputs = prompt_inputs(cfg, B, P, seed, dev)
    offset = position_offset(cfg)
    total = offset + P + gen + 8
    sample_gen = torch.Generator(dev).manual_seed(seed)

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, caches = api.prefill(params, inputs, cfg)
        sync()
        t_prefill = time.perf_counter() - t0

        caches = tree_map(_grow, api.make_caches(cfg, B, total, device=dev),
                          caches)
        token = _pick(logits[:, -1], cfg.vocab, 0.0, sample_gen)
        out = [token]
        t0 = time.perf_counter()
        for i in range(gen):
            pos = torch.full((B,), offset + P + i, dtype=torch.int32,
                             device=dev)
            logits_t, caches = api.decode_step(
                params, caches, {"token": token, "pos": pos}, cfg)
            token = _pick(logits_t, cfg.vocab, temperature, sample_gen)
            out.append(token)
        sync()
        t_decode = time.perf_counter() - t0
    return ServeResult(torch.stack(out, 1).cpu().numpy(), t_prefill, t_decode)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-impl", choices=["auto", "full", "chunked", "pallas"],
                    default=None, help="default: the config's own attn_impl")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap


def config_from_args(args) -> ArchConfig:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    return cfg


def main(argv=None) -> ServeResult:
    args = build_parser().parse_args(argv)
    res = serve(config_from_args(args), batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen,
                temperature=args.temperature, seed=args.seed,
                device=args.device)
    print(res.summary())
    print("sample tokens[0]:", res.tokens[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
