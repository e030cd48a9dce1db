"""Neural audio codecs of the port: Mimi, EnCodec, SNAC, DAC, Vocos,
BigVGAN and the S3 tokenizers (counterpart of ``mlx_audio_tpu.codec``).

Exported lazily, as in the JAX package, so that importing the package
stays cheap: a codec's module loads on first attribute access.
"""

_EXPORTS = {
    "DAC": "dac",
    "Encodec": "encodec",
    "Mimi": "mimi",
    "SNAC": "snac",
    "Vocos": "vocos",
    "BigVGAN": "bigvgan",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(
            f"mlx_audio_tpu_torch.codec.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
