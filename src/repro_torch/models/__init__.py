"""The paper's five model families (``paper``), their primitives (``nn``)
and the LM substrate (counterpart of ``repro/models``).

The paper's constructors are exported lazily: ``paper`` imports the losses
of ``repro_torch.core``, whose package imports the kernels, and a kernel
module imports ``models.attention_core``; an eager import here would close
that loop for whoever imports a kernel module first."""

_PAPER = ("Model", "char_lstm", "cifar_cnn", "mnist_2nn", "mnist_cnn", "word_lstm")
__all__ = list(_PAPER)


def __getattr__(name):
    if name in _PAPER:
        from repro_torch.models import paper

        return getattr(paper, name)
    raise AttributeError(f"module 'repro_torch.models' has no attribute {name!r}")
