"""The port's end-to-end examples, the counterparts of the JAX round's
``examples/*.py``; each runs as ``python -m repro_torch.examples.<name>``
and its ``main(argv)`` returns every figure it prints.

* ``quickstart`` — create an image, a fine-tune deduplicated against
  it, a demand restore of one tensor and of half a shard, a GC
  generation roll and a restore after it;
* ``serve_finetunes`` — ten tenants' fine-tunes of one base cold-started
  through one shared ``ImageService`` with an L2 node failed;
* ``coldstart_drill`` — the paper's §4.2 drill: every cache tier
  flushed under a Zipf trace, and the return to steady-state hit rates;
* ``train_lm`` — a ~100M-parameter LM trained with async checkpoints, a
  crash half way and a resume in a new trainer.

Each defaults to ``--device cuda`` (the kernels) and runs on the CPU
only when asked (``--device cpu``: the host crypto backend and the
plain PyTorch versions)."""

DEVICES = ("cuda", "cpu")


def backend_for(device: str) -> str:
    """The decode and publish backend of `device`: the CUDA kernels on
    the card, the host crypto (numpy AES, hashlib) on the CPU, as
    ``launch.train`` picks it."""
    return "python" if device == "cpu" else "torch-fused"
