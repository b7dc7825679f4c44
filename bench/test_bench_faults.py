"""The check that decides ``correct`` must fail: the control (the
program's own bfloat16 load, the precision below the configuration's
float32) and each fault a cell can have, planted under a CPU run of the
harness that skips only its look for a card. One chip: no exchange
between chips to leave out."""
from __future__ import annotations

import numpy as np
import pytest

import bench_cpu_cells as cpu

CELLS = ("whisper-base.scaleout-l2", "xlstm-350m.restart-l1")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = cpu.measure(cpu.cpu_cell(name))
    assert out["correct"] and out["attempted"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_bfloat16_load_is_not_correct(name):
    out = cpu.measure(cpu.cpu_cell(name, serve_dtype="bfloat16"))
    assert not out["correct"]
    assert out["checks"]["bad_leaves"]["value"] > 0


def _patch_restore(monkeypatch, alter):
    from repro_torch.core.service import ImageHandle
    orig = ImageHandle.restore_tree

    def restore_tree(self, *a, **kw):
        return alter({k: np.array(v) for k, v in
                      orig(self, *a, **kw).items()})
    monkeypatch.setattr(ImageHandle, "restore_tree", restore_tree)


def test_fault_state_unchanged(monkeypatch):
    """A cold start that loads nothing leaves the slot as it was."""
    from repro_torch.models.lm import DecoderLM
    monkeypatch.setattr(DecoderLM, "load_flat", lambda self, flat: self)
    out = cpu.measure(cpu.cpu_cell("xlstm-350m.restart-l1"))
    assert not out["correct"] and out["checks"]["unloaded"]["value"] > 0


def test_fault_half_left_out(monkeypatch):
    """Half of every restored tensor never arrives (left as zeros)."""
    def alter(tree):
        for a in tree.values():
            a.reshape(-1)[a.size // 2:] = 0
        return tree
    _patch_restore(monkeypatch, alter)
    out = cpu.measure(cpu.cpu_cell("whisper-base.scaleout-l2"))
    assert not out["correct"] and out["checks"]["bad_leaves"]["value"] > 0


def test_fault_answer_altered_where_produced(monkeypatch):
    """One value of one restored tensor one ulp off."""
    def alter(tree):
        a = tree[min(tree)].reshape(-1)
        a[0] = np.nextafter(a[0], np.float32(np.inf))
        return tree
    _patch_restore(monkeypatch, alter)
    out = cpu.measure(cpu.cpu_cell("xlstm-350m.restart-l1"))
    assert not out["correct"] and out["checks"]["bad_leaves"]["value"] > 0


def test_fault_ciphertext_altered_at_the_origin(monkeypatch):
    """Chunks reach the origin altered (the worker's L1 keeps the sound
    copies, so the window's answers are right): the reference's check of
    the write path finds them."""
    from repro_torch.core.publish import PublishPipeline
    orig = PublishPipeline._put

    def put(self, root, name, ct):
        return orig(self, root, name, bytes([ct[0] ^ 1]) + ct[1:])
    monkeypatch.setattr(PublishPipeline, "_put", put)
    out = cpu.measure(cpu.cpu_cell("xlstm-350m.restart-l1"))
    assert not out["correct"] and out["checks"]["bad_chunks"]["value"] > 0
