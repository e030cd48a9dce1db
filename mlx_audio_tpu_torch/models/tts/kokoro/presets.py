"""Kokoro-82M architecture preset (counterpart of
``mlx_audio_tpu/models/tts/kokoro/presets.py``): the published config.json
of the Kokoro-82M checkpoint, with the standard Kokoro phoneme vocabulary."""

from __future__ import annotations

from mlx_audio_tpu_torch.models.tts.kokoro.model import ModelConfig

# Standard Kokoro phoneme vocabulary (config.json "vocab"): ids are stable
# across checkpoints; symbol 0 is the pad/boundary token.
_SYMBOLS = (
    "$;:,.!?¡¿—…\"«»“” ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)


def kokoro_vocab() -> dict:
    return {s: i for i, s in enumerate(_SYMBOLS)}


def kokoro_82m_config() -> ModelConfig:
    return ModelConfig(
        istftnet={
            "resblock_kernel_sizes": [3, 7, 11],
            "upsample_rates": [10, 6],
            "upsample_initial_channel": 512,
            "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
            "upsample_kernel_sizes": [20, 12],
            "gen_istft_n_fft": 20,
            "gen_istft_hop_size": 5,
        },
        dim_in=64,
        dropout=0.2,
        hidden_dim=512,
        max_conv_dim=512,
        max_dur=50,
        multispeaker=True,
        n_layer=3,
        n_mels=80,
        n_token=178,
        style_dim=128,
        text_encoder_kernel_size=5,
        plbert={
            "hidden_size": 768,
            "num_attention_heads": 12,
            "intermediate_size": 2048,
            "max_position_embeddings": 512,
            "num_hidden_layers": 12,
            "dropout": 0.1,
        },
        vocab=kokoro_vocab(),
    )
