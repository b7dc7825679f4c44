"""The one general generator. A configuration file fixes the image and the
deployment; a traffic mix file fixes the clients, the workers and how the
tiers are warmed. From them and the seed this module builds the cell's
set-up, runs its closed-loop window through ``repro_torch``'s
``ImageService`` and ``cold_start``, and judges what the window produced
against the reference.

Set-up: the weights are drawn on the device from the seed (one
``torch.Generator``, one large draw per image) and copied once to the
host; function 0 is the base image and each further function redraws
the layer ``fine_tune_layer`` of every leaf under ``fine_tune_prefix``.
Every function is published through ``ImageService.publish`` into a
fresh origin ``ChunkStore`` under ``TMPDIR``. One cold start of each
function, one after another on workers of the kind the window uses,
fills the tiers; then every client cold-starts at once, which warms what
the window's concurrent cold starts use (on the card, a first wave of
four took twice as long as the waves after it), so the window starts
warm.

Mix keys: ``clients`` (closed-loop client threads); ``worker``:
``"fresh"`` (each cold start on a new ``ImageService`` with an empty L1,
sharing the L2 and the origin) or ``"shared"`` (one ``ImageService`` for
every client, which also publishes, so its L1 holds every chunk);
``l1_bytes`` (the worker's L1); ``retain_share`` and ``retain_max``
(which window cold starts keep their loaded weights for the check, drawn
from the seed); ``check_ciphertexts`` (chunks per image whose ciphertext
the reference recomputes).
"""
from __future__ import annotations

import hashlib
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from benchkit import reference
from benchkit.trace import DeviceTrace

TENANT = "bench"


@dataclass
class Function:
    tree: dict                  # {path: float32 numpy array}
    blob: bytes = b""           # the sealed manifest publish returned
    image_bytes: int = 0        # the reference layout's image size
    distinct_chunks: int = 0    # distinct non-zero chunks (after the check)


@dataclass
class Run:
    """What a run hands to each per-layer metric's reader."""
    cell: object
    device: object
    records: list = field(default_factory=list)  # one dict a cold start
    functions: list = field(default_factory=list)
    setup: dict = field(default_factory=dict)    # seconds by stage
    window_s: float = 0.0
    counters: dict = field(default_factory=dict)  # COUNTERS delta
    trace: DeviceTrace | None = None
    answers_checked: int = 0
    memory_peak_bytes: int = 0  # on the card, retained answers left out
    host: dict = field(default_factory=dict)  # the window's host readings

    @property
    def done(self) -> list:
        return [r for r in self.records if "stats" in r]

    def coldstart_bytes(self) -> int:
        return sum(self.functions[r["function"]].image_bytes
                   for r in self.done)

    def decoded_chunks(self) -> int:
        return sum(self.functions[r["function"]].distinct_chunks
                   for r in self.done)


def flat_shapes(nested: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in nested.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_shapes(v, name + "/"))
        else:
            out[name] = tuple(v.shape)
    return out


def flat_params(params) -> dict | None:
    if params is None:
        return None
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": t for n, t in flat_params(v).items()})
        else:
            out[k] = v
    return out


def tree_bytes(params) -> int:
    """Bytes of the tensors of a model's ``params`` tree."""
    return sum(t.numel() * t.element_size()
               for t in (flat_params(params) or {}).values())


def host_readings() -> dict:
    """This process's CPU seconds, user and system, which the window's
    diagnostics difference: a slow run that spent as many CPU seconds
    as a fast one did less work per second of the host's CPU."""
    import os
    t = os.times()
    return {"user_s": t.user, "system_s": t.system}


def draw_functions(shapes: dict, config: dict, seed: int, device) -> list:
    """The functions' host trees (module doc): float32 normals of the
    configuration's ``weights.std``, drawn on `device`."""
    import torch
    names = sorted(shapes)
    sizes = [int(np.prod(shapes[n], dtype=np.int64)) for n in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    std = float(config["weights"]["std"])

    def draw(n: int) -> np.ndarray:
        return torch.randn(n, generator=gen, device=device,
                           dtype=torch.float32).mul_(std).cpu().numpy()

    flat = draw(sum(sizes))
    base, off = {}, 0
    for n, k in zip(names, sizes):
        base[n] = flat[off:off + k].reshape(shapes[n])
        off += k
    fn = config["functions"]
    prefix, layer = fn.get("fine_tune_prefix"), fn.get("fine_tune_layer", -1)
    tuned = [n for n in names if prefix and n.startswith(prefix)]
    trees = [base]
    for _ in range(int(fn["count"]) - 1):
        per = [int(np.prod(shapes[n][1:], dtype=np.int64)) for n in tuned]
        redraw = draw(sum(per))
        tree, off = dict(base), 0
        for n, k in zip(tuned, per):
            a = base[n].copy()
            a[layer] = redraw[off:off + k].reshape(shapes[n][1:])
            tree[n] = a
            off += k
        trees.append(tree)
    return trees


class CellRun:
    """One run of a cell: ``setup()``, ``window(seconds)``, ``check()``,
    ``close()``."""

    def __init__(self, cell, seed: int, device="cuda", traced: bool = False):
        import torch
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.traced = traced
        self.run = Run(cell, self.device)
        self.key = hashlib.sha256(b"bench tenant key %d" % self.seed).digest()
        self.store_dir = None
        self.services: list = []
        self.shared = None
        self.models: list = []
        self.last_function: dict = {}

    # ------------------------------------------------------------ set-up
    def _service_config(self, *, l2: bool):
        from repro_torch.core.service import ServiceConfig
        dep = self.cell.config["deployment"]
        kw = dict(device=str(self.device), root=dep["root"],
                  l1_bytes=int(self.cell.mix["l1_bytes"]),
                  max_coldstarts=dep["max_coldstarts"],
                  fetch_concurrency=dep["fetch_concurrency"],
                  decode_backend=dep["decode_backend"],
                  max_batch_bytes=dep["max_batch_bytes"])
        if l2:
            kw.update(l2_nodes=dep["l2_nodes"], l2_seed=self.seed % (1 << 32),
                      l2_mem_bytes=dep["l2_mem_bytes"],
                      l2_flash_bytes=dep["l2_flash_bytes"])
        return ServiceConfig(**kw)

    def worker(self):
        """The ImageService a cold start runs on (the mix's ``worker``)."""
        if self.shared is not None:
            return self.shared
        from repro_torch.core.service import ImageService
        return ImageService(self.store, self._service_config(l2=False),
                            l2=self.l2)

    def _cold_start(self, client: int, fi: int) -> dict:
        """One cold start of function `fi` into client `client`'s model,
        the slot's previous weights dropped first; returns its stats."""
        from repro_torch.serve.coldstart import cold_start
        model = self.models[client]
        svc = self.worker()
        model.params = None
        try:
            _, stats = cold_start(model, self.run.functions[fi].blob,
                                  self.key, svc)
        finally:
            if svc is not self.shared:
                svc.close()
        self.last_function[client] = fi
        return stats

    def setup(self) -> None:
        import torch

        from repro_torch.configs.base import ModelConfig
        from repro_torch.core.service import ImageService
        from repro_torch.core.store import ChunkStore
        from repro_torch.models import RunFlags, build_model

        cfg, mix = self.cell.config, self.cell.mix
        dep = cfg["deployment"]
        t = time.perf_counter()
        mcfg = ModelConfig(**cfg["model"])
        flags = RunFlags(dtype=cfg["serve_dtype"])
        self.models = [build_model(mcfg, flags, device=self.device)
                       for _ in range(int(mix["clients"]))]
        trees = draw_functions(flat_shapes(self.models[0].param_shapes()),
                               cfg, self.seed, self.device)
        self.run.functions = [Function(tr) for tr in trees]
        cs = int(dep["chunk_size"])
        for f in self.run.functions:
            f.image_bytes = reference.layout(f.tree, cs)[1]
        self.run.setup["weights_s"] = time.perf_counter() - t

        self.store_dir = tempfile.mkdtemp(prefix="bench-origin-")
        self.store = ChunkStore(self.store_dir)
        # the publisher holds the deployment's L2; a "shared" worker is
        # the publisher itself, so the publish warms its L1
        pub = ImageService(self.store, self._service_config(l2=True))
        self.services.append(pub)
        self.l2 = pub.l2
        if mix["worker"] == "shared":
            self.shared = pub
        elif mix["worker"] != "fresh":
            raise ValueError(f"unknown worker kind {mix['worker']!r}")
        t = time.perf_counter()
        for f in self.run.functions:
            f.blob, _ = pub.publish(f.tree, tenant=TENANT,
                                    tenant_key=self.key, root=dep["root"],
                                    chunk_size=cs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.run.setup["publish_s"] = time.perf_counter() - t
        t = time.perf_counter()
        n, nfn = len(self.models), len(self.run.functions)
        for fi in range(nfn):
            self._cold_start(fi % n, fi)
        self._concurrently([(c, c % nfn) for c in range(n)])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.run.setup["fill_s"] = time.perf_counter() - t

    def _concurrently(self, jobs: list) -> None:
        """Cold starts of (client, function) `jobs`, one thread each, all
        at once; the first failure is raised once all have ended."""
        errors: list = []

        def one(c: int, fi: int) -> None:
            try:
                self._cold_start(c, fi)
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=one, args=job) for job in jobs]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> None:
        """Closed loop: each client starts its next cold start when the
        last returns, until `seconds` have passed; the ones in flight
        then finish. ``run.window_s`` runs from the start to the last
        return."""
        import torch

        from repro_torch.core.telemetry import COUNTERS
        mix = self.cell.mix
        n = len(self.models)
        picks = [np.random.default_rng([self.seed, c]) for c in range(n)]
        share = float(mix["retain_share"])
        room = [int(mix["retain_max"])]
        lock = threading.Lock()
        records, errors = self.run.records, []
        nfn = len(self.run.functions)
        before = COUNTERS.snapshot()
        cuda = self.device.type == "cuda"
        # the peak without the answers kept for the check: at each one
        # kept, the peak so far less what was kept before, then a fresh
        # peak; what is kept only grows, so the difference is exact
        held, peak = [0], [0]

        def keep_answer(params) -> None:
            if not cuda:
                return
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated(
                self.device) - held[0])
            held[0] += tree_bytes(params)
            torch.cuda.reset_peak_memory_stats(self.device)

        l2_nodes = list(self.l2.nodes.values()) if self.l2 else []
        evictions_before = sum(n.mem.evictions for n in l2_nodes)
        host_before = host_readings()
        prof = None
        if self.traced:
            from torch.profiler import ProfilerActivity, profile
            # the card's activity alone (the CPU, where the tests run the
            # harness, has none to record)
            prof = profile(activities=[
                ProfilerActivity.CUDA if self.device.type == "cuda"
                else ProfilerActivity.CPU])
            prof.__enter__()
        t0 = time.perf_counter()
        stop = t0 + seconds

        def client(c: int) -> None:
            try:
                while True:
                    begin = time.perf_counter()
                    if begin >= stop:
                        return
                    fi = int(picks[c].integers(nfn))
                    rec = {"client": c, "function": fi, "begin": begin - t0,
                           "epoch_ns": [time.time_ns()]}
                    try:
                        rec["stats"] = self._cold_start(c, fi)
                    except Exception as e:      # a failed cold start
                        rec["error"] = repr(e)
                    rec["end"] = time.perf_counter() - t0
                    rec["epoch_ns"].append(time.time_ns())
                    keep = picks[c].random() < share
                    with lock:
                        if keep and "stats" in rec and room[0] > 0:
                            room[0] -= 1
                            rec["params"] = self.models[c].params
                            keep_answer(rec["params"])
                        records.append(rec)
            except BaseException as e:          # a fault of the harness
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"bench-client-{c}")
                   for c in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if cuda:
            torch.cuda.synchronize(self.device)
        end = time.perf_counter()
        host_after = host_readings()
        self.run.host = {k: host_after[k] - host_before[k]
                         for k in host_after}
        self.run.host["l2_mem_evictions"] = sum(
            n.mem.evictions for n in l2_nodes) - evictions_before
        if cuda:
            self.run.memory_peak_bytes = int(max(
                peak[0], torch.cuda.max_memory_allocated(self.device)
                - held[0]))
        if prof is not None:
            prof.__exit__(None, None, None)
            self.run.trace = DeviceTrace.from_profiler(
                prof, [(a * 1e-9, b * 1e-9)
                       for a, b in (r["epoch_ns"] for r in records)])
        if errors:
            raise errors[0]
        self.run.window_s = max([r["end"] for r in records],
                                default=end - t0)
        after = COUNTERS.snapshot()
        self.run.counters = {k: after.get(k, 0) - before.get(k, 0)
                             for k in set(after) | set(before)}

    # ------------------------------------------------------------- check
    def check(self) -> dict:
        """The numbers compared, each {value, limit}: cold starts that
        raised; answers holding no weights; leaves of the checked answers
        not bit-identical to the reference; and what the reference finds
        in the published images. Every limit is 0: the system's product
        is exact bytes."""
        import torch
        for svc in self.services:
            svc.close()
        dep, mix = self.cell.config["deployment"], self.cell.mix
        cs = int(dep["chunk_size"])
        rng = np.random.default_rng([self.seed, 1 << 20])
        image = {"manifest": 0, "chunks": 0, "ciphertexts": 0}
        for f in self.run.functions:
            nch = f.image_bytes // cs
            sample = rng.choice(nch, size=min(nch, int(mix["check_ciphertexts"])),
                                replace=False).tolist()
            bad = reference.check_image(
                f.blob, self.key, f.tree, store_dir=self.store_dir,
                root=dep["root"], tenant=TENANT, chunk_size=cs,
                sample=sample)
            for k in image:
                image[k] += bad[k]
            f.distinct_chunks = reference.distinct_chunks(f.tree, cs)
        answers = [(r["function"], r["params"]) for r in self.run.records
                   if "params" in r]
        answers += [(self.last_function[c], m.params)
                    for c, m in enumerate(self.models)]
        unloaded = sum(p is None for _, p in answers)
        bad_leaves = 0
        for fi, f in enumerate(self.run.functions):
            mine = [flat_params(p) for g, p in answers
                    if g == fi and p is not None]
            if not mine:
                continue
            for got in mine:
                bad_leaves += len(set(got) - set(f.tree))
            for name, arr in f.tree.items():
                want = torch.from_numpy(np.ascontiguousarray(arr)).to(
                    self.device)
                for got in mine:
                    t = got.get(name)
                    bad_leaves += t is None or t.dtype != want.dtype \
                        or t.shape != want.shape or not torch.equal(
                            t.contiguous().view(-1).view(torch.uint8),
                            want.view(-1).view(torch.uint8))
                del want
        done = len(self.run.done)
        numbers = {
            "failed": len(self.run.records) - done,
            "unloaded": unloaded,
            "bad_leaves": bad_leaves,
            "bad_manifest": image["manifest"],
            "bad_chunks": image["chunks"],
            "bad_ciphertexts": image["ciphertexts"],
        }
        self.run.answers_checked = len(answers)
        return {k: {"value": int(v), "limit": 0} for k, v in numbers.items()}

    def close(self) -> None:
        for svc in self.services:
            svc.close()
        self.models = []
        for r in self.run.records:
            r.pop("params", None)
        if self.store_dir is not None:
            shutil.rmtree(self.store_dir, ignore_errors=True)
            self.store_dir = None
