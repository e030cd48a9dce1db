"""Dia configuration: a copy of ``mlx_audio_tpu/models/tts/dia/config.py``
(pure Python).  ``DiaConfig()`` holds the published widths of
``nari-labs/Dia-1.6B``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class DataConfig:
    text_length: int = 1024
    audio_length: int = 3072
    channels: int = 9
    text_pad_value: int = 0
    audio_eos_value: int = 1024
    audio_pad_value: int = 1025
    audio_bos_value: int = 1026
    delay_pattern: List[int] = field(
        default_factory=lambda: [0, 8, 9, 10, 11, 12, 13, 14, 15]
    )


@dataclass
class EncoderConfig:
    n_layer: int = 12
    n_embd: int = 1024
    n_hidden: int = 4096
    n_head: int = 16
    head_dim: int = 128
    mlp_activations: List[str] = field(default_factory=lambda: ["silu", "linear"])
    use_pre_norm: bool = False


@dataclass
class DecoderConfig:
    n_layer: int = 18
    n_embd: int = 2048
    n_hidden: int = 8192
    gqa_query_heads: int = 16
    kv_heads: int = 4
    gqa_head_dim: int = 128
    cross_query_heads: int = 16
    cross_head_dim: int = 128
    mlp_activations: List[str] = field(default_factory=lambda: ["silu", "linear"])
    use_pre_norm: bool = False


@dataclass
class DiaModelConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    src_vocab_size: int = 128
    tgt_vocab_size: int = 1028
    dropout: float = 0.0
    normalization_layer_epsilon: float = 1e-5
    rope_min_timescale: float = 1.0
    rope_max_timescale: float = 10000.0
    sample_rate: int = 44100
    # The original nari-labs implementation applies RoPE to cross-attention
    # q/k; the HF-transformers port — the implementation the hub
    # `DiaForConditionalGeneration` checkpoints are distributed and
    # validated for — does not.  HF-format checkpoints load with this False.
    cross_attn_rope: bool = True


@dataclass
class DiaConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: DiaModelConfig = field(default_factory=DiaModelConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "DiaConfig":
        """The registry's name for :meth:`load_dict`."""
        return cls.load_dict(d)

    @classmethod
    def load_dict(cls, d: dict) -> "DiaConfig":
        if "decoder_config" in d or "encoder_config" in d:
            return cls.from_hf_dict(d)

        def sub(klass, key, parent):
            src = parent.get(key, {}) or {}
            valid = klass.__dataclass_fields__
            return klass(**{k: v for k, v in src.items() if k in valid})

        data = sub(DataConfig, "data", d)
        model_d = d.get("model", {}) or {}
        enc = sub(EncoderConfig, "encoder", model_d)
        dec = sub(DecoderConfig, "decoder", model_d)
        valid = DiaModelConfig.__dataclass_fields__
        model = DiaModelConfig(
            encoder=enc, decoder=dec,
            **{k: v for k, v in model_d.items()
               if k in valid and k not in ("encoder", "decoder")},
        )
        # sample_rate may live at the top level
        if "sample_rate" in d:
            model.sample_rate = d["sample_rate"]
        return cls(data=data, model=model)

    @classmethod
    def from_hf_dict(cls, d: dict) -> "DiaConfig":
        """Translate an HF-transformers `DiaConfig` dict (nari-labs/Dia-1.6B
        hub format: nested encoder_config/decoder_config) to our schema."""
        enc_d = d.get("encoder_config", {}) or {}
        dec_d = d.get("decoder_config", {}) or {}
        enc = EncoderConfig(
            n_layer=enc_d.get("num_hidden_layers", 12),
            n_embd=enc_d.get("hidden_size", 1024),
            n_hidden=enc_d.get("intermediate_size", 4096),
            n_head=enc_d.get("num_attention_heads", 16),
            head_dim=enc_d.get("head_dim", 128),
        )
        dec = DecoderConfig(
            n_layer=dec_d.get("num_hidden_layers", 18),
            n_embd=dec_d.get("hidden_size", 2048),
            n_hidden=dec_d.get("intermediate_size", 8192),
            gqa_query_heads=dec_d.get("num_attention_heads", 16),
            kv_heads=dec_d.get("num_key_value_heads", 4),
            gqa_head_dim=dec_d.get("head_dim", 128),
            cross_query_heads=dec_d.get("cross_num_attention_heads", 16),
            cross_head_dim=dec_d.get("cross_head_dim", 128),
        )
        model = DiaModelConfig(
            encoder=enc, decoder=dec,
            src_vocab_size=enc_d.get("vocab_size", 256),
            tgt_vocab_size=dec_d.get("vocab_size", 1028),
            normalization_layer_epsilon=dec_d.get("norm_eps", 1e-5),
            rope_max_timescale=dec_d.get("rope_theta", 10000.0),
            sample_rate=d.get("sample_rate", 44100),
            cross_attn_rope=False,
        )
        data = DataConfig(
            text_length=enc_d.get("max_position_embeddings", 1024),
            audio_length=dec_d.get("max_position_embeddings", 3072),
            channels=dec_d.get("num_channels", 9),
            audio_eos_value=d.get("eos_token_id", 1024),
            audio_pad_value=d.get("pad_token_id", 1025),
            audio_bos_value=d.get("bos_token_id", 1026),
            delay_pattern=list(d.get("delay_pattern",
                                     [0, 8, 9, 10, 11, 12, 13, 14, 15])),
        )
        return cls(data=data, model=model)
