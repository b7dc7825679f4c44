#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):

1. toolchain — card name and power limit, nvcc, torch and CUDA
   versions, whether triton imports; builds the three CUDA kernels of
   ``src/repro_torch/csrc`` (one nvcc per source, in parallel).
2. kernels — each kernel against its plain PyTorch version on the card
   and against the numpy/hashlib oracles, on lengths 0, 1, 55, 56, 63,
   64, 65, 4096 and 512 KiB and on a tile of 256 x 512 KiB chunks with
   distinct keys (exact bytes); a one-byte tamper must raise
   ``IntegrityError`` naming its chunk. Times each kernel and its plain
   version at the tile, and the fused pass at 1 MiB tiles against the
   registered 128 MiB tile.
3. main path — SmolLM-360M at full width (random weights from
   ``--seed``): ``ImageService.publish`` (SHA and AES kernels),
   ``cold_start`` through a second service on the same store, whose L1
   starts empty so every chunk comes from the origin (fused kernel), a
   byte-identity check of the restored
   tree, and a ``ServeEngine`` answering 4 requests whose greedy tokens
   must equal those of the same weights loaded without the image.

The last lines are the kernel table (``{"kernels": [...]}``), the
launch counts of phase 3, the ``nvidia-smi`` name/power-limit line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The card's peaks (NVIDIA H100 SXM data sheet, dense, 700 W): HBM
# 3.35 TB/s; 32-bit integer ALU rate 16.7 Tops/s, i.e. 132 SMs x 64
# INT32 lanes x 1.98 GHz (half the lanes of the 67 TFLOP/s float32 peak,
# which counts an FMA as two).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Operations are counted as the fewest 32-bit instructions that
# crypto_common.cuh's bodies need at that rate: a 3-input logic op is one
# LOP3, a 3-input add one IADD3, a rotate one SHF, a byte extract or
# byte swap one PRMT, a table read one op; address arithmetic is not
# counted. Each count is a floor, so each bound is a least time.
# SHA-256 per 64-byte block: 16 byte swaps; schedule 48 x 10 (per sigma
# 2 SHF + 1 shift + 1 LOP3; 2 adds); rounds 64 x 14 (per Sigma 3 SHF +
# 1 LOP3; ch and maj 1 LOP3 each; t1 2 IADD3; a and e 1 add each);
# final 8 adds.
SHA_OPS_PER_BLOCK = 16 + 48 * 10 + 64 * 14 + 8
# AES-256 per 16-byte block (T-table): initial key xor 4; 13 middle
# rounds x 40 (per column 4 byte extracts, 4 table reads, 2 LOP3 for the
# five-way xor); final round 48 (per column 4 extracts, 4 S-box reads,
# 3 PRMT to assemble the word, 1 key xor).
AES_OPS_PER_BLOCK = 4 + 13 * 40 + 48
KIB512 = 512 << 10
ODD_LENGTHS = (0, 1, 55, 56, 63, 64, 65, 4096, KIB512)
TPU_KERNELS = {
    "fused_verify_decrypt": ("src/repro_torch/csrc/fused.cu",
                             "src/repro/kernels/fused/fusedp.py:107"),
    "sha256_many": ("src/repro_torch/csrc/sha256.cu",
                    "src/repro/kernels/sha256/sha256p.py:91"),
    "aes_encrypt_many": ("src/repro_torch/csrc/aes.cu",
                         "src/repro/kernels/aes/bitslice_pallas.py:55"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def sh(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def sha_blocks(lengths) -> int:
    return sum((int(n) + 72) // 64 for n in lengths)


def bound(nbytes: float, ops: float) -> tuple:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of `fn` over `reps` runs, CUDA events, after one warmup."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn) -> tuple:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(a, b) -> int:
    return int((a.to(b.device).long() - b.long()).abs().max()) \
        if a.numel() else 0


# ------------------------------------------------------------- phase 1

def phase_toolchain(kernels) -> str:
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()
    smi_line = smi[0] if smi else "unavailable"
    import torch
    log("card:", smi_line)
    log("nvcc:", sh([kernels._nvcc(), "--version"]).splitlines()[-1])
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))
    try:
        import triton
        log("triton", triton.__version__)
    except ImportError:
        log("triton: not importable")
    t0 = time.perf_counter()
    info = kernels.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, rec in info.items():
        regs = [ln.strip() for ln in rec["ptxas"].splitlines()
                if "registers" in ln or "smem" in ln]
        log(f"  {name}: {rec['lib']} ({rec['seconds']:.2f} s) {regs}")
    return smi_line


# ------------------------------------------------------------- phase 2

def phase_kernels(rng, tile_chunks: int, tile_len: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.crypto import aes, convergent
    from repro_torch.kernels.aes import ops as aops
    from repro_torch.kernels.fused import ops as fops
    from repro_torch.kernels.sha256 import ops as sops

    dev = torch.device("cuda")
    rows = {}

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    odd = [rand(n) for n in ODD_LENGTHS]
    odd_keys = [rand(32) for _ in odd]
    small = [i for i, n in enumerate(ODD_LENGTHS) if n <= 4096]
    tile = [rand(tile_len) for _ in range(tile_chunks)]
    tile_keys = [rand(32) for _ in tile]

    # ---------------- SHA-256
    got = sops.sha256_many(odd, device=dev)
    check(got == [hashlib.sha256(m).digest() for m in odd],
          "sha256 kernel != hashlib on the odd lengths")
    sm = sops.to_device(*sops.pack_messages([odd[i] for i in small]), dev)
    check(torch.equal(sops.sha256_lanes(*sm).cpu(),
                      sops.sha256_lanes_plain(*sm).cpu()),
          "sha256 kernel != plain on the odd lengths")
    tb = sops.to_device(*sops.pack_messages(tile), dev)
    kd = sops.sha256_lanes(*tb)
    ref = np.frombuffer(b"".join(hashlib.sha256(m).digest() for m in tile),
                        np.uint8).reshape(-1, 32)
    check(np.array_equal(kd.cpu().numpy(), ref), "sha256 kernel != hashlib "
          "on the tile")
    ms = cuda_ms(lambda: sops.sha256_lanes(*tb), 3)
    pd, plain_ms = wall_ms(lambda: sops.sha256_lanes_plain(*tb))
    err = max_abs_err(kd, pd)
    check(err == 0, "sha256 kernel != plain on the tile")
    nbytes = tile_chunks * tile_len
    rows["sha256_many"] = dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=err,
        bound=bound(nbytes + 48 * tile_chunks,
                    sha_blocks([tile_len] * tile_chunks) * SHA_OPS_PER_BLOCK))
    log(f"sha256: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"{nbytes / ms / 1e6:.3f} GB/s at {tile_chunks} x {tile_len} B")

    # ---------------- AES (the publish path's CTR counter blocks)
    def hook(blocks, rks, counts=None):
        return aops.encrypt_many(blocks, rks, counts=counts, device=dev)
    hook.per_chunk_rks = True
    lens = [len(m) for m in odd]
    ks = aes.ctr_keystream_many(odd_keys, lens, encrypt_many=hook)
    ks_ref = aes.ctr_keystream_many(odd_keys, lens)
    check(all(np.array_equal(a, b) for a, b in zip(ks, ks_ref)),
          "aes kernel != numpy T-table keystreams on the odd lengths")
    check((np.frombuffer(odd[-1], np.uint8) ^ ks[-1]).tobytes()
          == aes.ctr_encrypt(odd[-1], odd_keys[-1]),
          "aes kernel CTR != ctr_encrypt at 512 KiB")
    nb = tile_len // 16
    ctr = np.zeros((tile_chunks * nb, 16), np.uint8)
    ctr[:, 8:] = np.tile(np.arange(nb, dtype=">u8"), tile_chunks) \
        .view(np.uint8).reshape(-1, 8)
    rks_np = aes.expand_keys_many(tile_keys)
    blocks = torch.from_numpy(ctr).to(dev)
    rks = torch.from_numpy(rks_np.view(np.int32)).to(dev)
    idx = torch.from_numpy(np.repeat(np.arange(tile_chunks, dtype=np.int32),
                                     nb)).to(dev)
    ka = aops.aes_encrypt_blocks(blocks, rks, idx)
    sample = rng.choice(ctr.shape[0], min(4096, ctr.shape[0]),
                        replace=False)
    check(np.array_equal(ka.cpu().numpy()[sample], aes.encrypt_blocks(
        ctr[sample], rks_np[idx.cpu().numpy()[sample]])),
        "aes kernel != encrypt_blocks on a tile sample")
    ms = cuda_ms(lambda: aops.aes_encrypt_blocks(blocks, rks, idx), 5)
    pa, plain_ms = wall_ms(
        lambda: aops.aes_encrypt_blocks_plain(blocks, rks, idx))
    err = max_abs_err(ka, pa)
    check(err == 0, "aes kernel != plain on the tile")
    n = ctr.shape[0]
    rows["aes_encrypt_many"] = dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=err,
        bound=bound(36 * n + rks_np.nbytes, n * AES_OPS_PER_BLOCK))
    log(f"aes: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"{16 * n / ms / 1e6:.3f} GB/s at {n} blocks")
    del blocks, idx, ka, pa

    # ---------------- fused verify+decrypt
    dig, pts = fops.fused_verify_decrypt(odd, odd_keys, device=dev)
    check(dig == [hashlib.sha256(m).digest() for m in odd],
          "fused digests != hashlib on the odd lengths")
    check(pts == [aes.ctr_decrypt(m, k) for m, k in zip(odd, odd_keys)],
          "fused plaintexts != ctr_decrypt on the odd lengths")
    sm = sops.to_device(*sops.pack_messages([odd[i] for i in small]), dev)
    srk = torch.from_numpy(fops.round_keys([odd_keys[i] for i in small])
                           .view(np.int32)).to(dev)
    kp, kdg = fops.fused_verify_decrypt_lanes(*sm, srk)
    pp, pdg = fops.fused_lanes_plain(*sm, srk)
    check(torch.equal(kdg, pdg), "fused digests != plain on odd lengths")
    for o, ln in zip(sm[1].tolist(), sm[2].tolist()):
        check(torch.equal(kp[o:o + ln], pp[o:o + ln]),
              "fused plaintext != plain on the odd lengths")
    trk = torch.from_numpy(fops.round_keys(tile_keys).view(np.int32)).to(dev)
    kp, kdg = fops.fused_verify_decrypt_lanes(*tb, trk)
    check(np.array_equal(kdg.cpu().numpy(), ref),
          "fused digests != hashlib on the tile")
    kp_np = kp.cpu().numpy()
    offs = tb[1].cpu().numpy()
    for i in (0, tile_chunks // 2, tile_chunks - 1):
        check(kp_np[offs[i]:offs[i] + tile_len].tobytes()
              == aes.ctr_decrypt(tile[i], tile_keys[i]),
              f"fused plaintext != ctr_decrypt on tile chunk {i}")
    ms = cuda_ms(lambda: fops.fused_verify_decrypt_lanes(*tb, trk), 3)
    (pp, pdg), plain_ms = wall_ms(lambda: fops.fused_lanes_plain(*tb, trk))
    err = max(max_abs_err(kdg, pdg), max_abs_err(kp, pp))
    check(err == 0, "fused kernel != plain on the tile")
    ops = sha_blocks([tile_len] * tile_chunks) * SHA_OPS_PER_BLOCK \
        + tile_chunks * (tile_len // 16) * (AES_OPS_PER_BLOCK + 4)
    rows["fused_verify_decrypt"] = dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=err,
        bound=bound(2 * nbytes + tile_chunks * (32 + 16 + 240), ops))
    log(f"fused: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"{nbytes / ms / 1e6:.3f} GB/s at {tile_chunks} x {tile_len} B")
    del pp, pdg, kp

    # ---------------- tamper: IntegrityError names the chunk
    encs = [convergent.encrypt_chunk(m, b"smoke-salt-16by!") for m in tile[:8]]
    cts = [e.ciphertext for e in encs]
    bad = bytearray(cts[3])
    bad[len(bad) // 2] ^= 1
    cts[3] = bytes(bad)
    try:
        convergent.decrypt_chunks(
            cts, [e.key for e in encs], [e.sha256 for e in encs],
            fused=lambda c, k: fops.fused_verify_decrypt(c, k, device=dev))
    except convergent.IntegrityError as e:
        check(e.bad_positions == [3], f"tamper named {e.bad_positions}")
    else:
        raise SmokeFailure("a tampered chunk decrypted without error")
    log("tamper: IntegrityError names chunk 3")

    # ---------------- tile size: 1 MiB tiles (the JAX autotuner's top)
    # against the registered 128 MiB tile, same chunks, through the hook
    per = max(1, (1 << 20) // tile_len)

    def tiled(step):
        for i in range(0, tile_chunks, step):
            fops.fused_verify_decrypt(tile[i:i + step], tile_keys[i:i + step],
                                      device=dev)
    _, small_ms = wall_ms(lambda: tiled(per))
    _, big_ms = wall_ms(lambda: tiled(tile_chunks))
    rows["tile_effect"] = {"chunks": tile_chunks, "small_tile_ms": small_ms,
                           "small_tile_chunks": per, "big_tile_ms": big_ms}
    log(f"tile effect: {tile_chunks} chunks through the fused hook: "
        f"{per}-chunk tiles {small_ms:.1f} ms, one tile {big_ms:.1f} ms")
    return rows


# ------------------------------------------------------------- phase 3

def phase_main_path(seed: int, kernels) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    from repro_torch.models import DecoderLM, init_flat
    from repro_torch.serve.coldstart import cold_start
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config("smollm-360m")
    t0 = time.perf_counter()
    flat = init_flat(cfg, seed)
    nparams = sum(a.size for a in flat.values())
    log(f"model {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{nparams / 1e6:.1f} M params, weights made in "
        f"{time.perf_counter() - t0:.1f} s")
    want = {k: hashlib.sha256(v.tobytes()).hexdigest() for k, v in flat.items()}
    tmp = ROOT / "build" / f"smoke-store-{seed}"
    shutil.rmtree(tmp, ignore_errors=True)
    key = hashlib.sha256(b"smoke tenant key").digest()
    out = {}
    try:
        store = ChunkStore(tmp)
        svc = ImageService(store, ServiceConfig(device="cuda", root="r0"))
        kernels.reset_launches()
        t0 = time.perf_counter()
        blob, st = svc.publish(flat, tenant="smoke", tenant_key=key)
        torch.cuda.synchronize()
        pub_s = time.perf_counter() - t0
        timing = svc.publisher().last_timing
        out["publish_s"] = pub_s
        out["publish_GBps"] = st.bytes_total / pub_s / 1e9
        out["publish_crypto_s"] = timing["crypto_s"]
        out["image_bytes"] = st.bytes_total
        out["chunks"] = st.total_chunks
        log(f"publish: {pub_s:.2f} s, {out['publish_GBps']:.3f} GB/s, "
            f"{st.total_chunks} chunks ({st.zero_chunks} zero), crypto "
            f"hooks {timing['crypto_s']:.2f} s, image id "
            f"{timing['image_id_s']:.2f} s")
        svc.close()

        # a worker that never published: its L1 starts empty
        svc = ImageService(store, ServiceConfig(device="cuda", root="r0"))
        model = DecoderLM(cfg, device="cuda")
        engine, cs = cold_start(model, blob, key, svc)
        check(cs["origin_fetches"] >= st.unique_chunks,
              f"cold start fetched {cs['origin_fetches']} chunks from the "
              f"origin, fewer than the {st.unique_chunks} stored")
        out.update({k: cs[k] for k in (
            "load_seconds", "restore_seconds", "fetch_wall_s",
            "decode_wall_s", "overlap_fraction", "decode_tiles",
            "origin_fetches")})
        log("cold start:", json.dumps({k: out[k] for k in cs if k in out}))

        handle = svc.open(blob, key)
        restored = handle.restore_tree()
        got = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
               for k, v in restored.items()}
        check(got == want, "restored tree differs from the published one")
        del restored
        log(f"restore: {len(got)} tensors byte-identical (per-tensor SHA-256)")
        launches = dict(kernels.LAUNCHES)

        prompts = [rng_prompt(seed + i, cfg.vocab_size) for i in range(4)]
        reqs = [Request(i, prompt=p, max_new=16) for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        torch.cuda.synchronize()
        res = engine.run_until_drained()
        new_tokens = sum(len(r.out) for r in reqs)
        out["decode_tokens_per_s"] = new_tokens / res["seconds"]
        out["engine_steps"] = res["steps"]
        check(all(r.done and len(r.out) == 16 for r in reqs),
              "requests did not complete")
        ref_model = DecoderLM(cfg, device="cuda").load_flat(flat)
        ref = ServeEngine(ref_model, max_batch=4, max_len=128)
        rreqs = [Request(i, prompt=p, max_new=16)
                 for i, p in enumerate(prompts)]
        for r in rreqs:
            ref.submit(r)
        ref.run_until_drained()
        check([r.out for r in reqs] == [r.out for r in rreqs],
              "cold-started tokens differ from the image-free model's")
        log(f"serve: 4 requests, {new_tokens} tokens, "
            f"{out['decode_tokens_per_s']:.1f} tokens/s, tokens equal "
            f"the image-free model's; first: {reqs[0].out}")
        out["peak_device_GB"] = torch.cuda.max_memory_allocated() / 1e9
        out["launches"] = launches
        svc.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def rng_prompt(seed: int, vocab: int) -> list:
    import numpy as np
    return [int(t) for t in
            np.random.default_rng(seed).integers(0, vocab, 8)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from repro_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    try:
        smi_line = phase_toolchain(kernels)
        rng = np.random.default_rng(args.seed)
        rows = phase_kernels(rng, 256, KIB512)
        main_path = phase_main_path(args.seed, kernels)
        for name, n in main_path["launches"].items():
            check(n > 0, f"kernel {name} was not launched on the main path")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    table = []
    for name, (src, replaces) in TPU_KERNELS.items():
        r = rows[name]
        bound_ms, bound_by = r["bound"]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces,
                      "launches": main_path["launches"][name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None})
    summary = {k: v for k, v in main_path.items() if k != "launches"}
    summary["tile_effect"] = rows["tile_effect"]
    summary["smoke_seconds"] = time.perf_counter() - t_all
    log("main path:", json.dumps(summary))
    log(json.dumps({"launches": main_path["launches"]}))
    log(json.dumps({"kernels": table}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
