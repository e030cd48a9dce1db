"""mlx_audio_tpu_torch: the PyTorch and CUDA port of mlx_audio_tpu.

The JAX package ``mlx_audio_tpu`` is the reference; this package mirrors its
layout and names and imports nothing of it, nor JAX.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.  The hot kernels are
CUDA C++ for Hopper (``csrc/``), compiled at first use (``build.py``); on
CPU tensors each kernel's plain PyTorch version runs instead.

Ported so far: Kokoro-82M synthesis end to end
(``mlx_audio_tpu_torch.models.tts.kokoro``); CSM-1B speech through int8
weight-only decode and the speculative depth decode, whole or streamed
(``mlx_audio_tpu_torch.models.tts.sesame``, with Llama in ``models.lm``,
Mimi's batch and stateful paths in ``codec.mimi`` and ``nn.quantize``);
Orpheus, OuteTTS, Dia and Bark (``models.tts.llama``, ``outetts``, ``dia``,
``bark``) on the causal-LM loop (``models.lm.causal``) or their own;
Spark-TTS; Wav2Vec2, Whisper, Voxtral and Parakeet speech to text
(``models.stt``); the SNAC, DAC and EnCodec codecs and the Vocos and
BigVGAN vocoders (``codec``); audio file I/O (``utils.audio_io``); the
depth-draft probes (``mlx_audio_tpu_torch.scripts.probe_depth``); and the
device mesh (``parallel``: data- and tensor-parallel placements that every
batched entry point consults, the CLIs' and the server's ``--mesh``, and a
mesh over several processes through ``parallel.distributed``).  The
package exports what the JAX package's does.
"""

__version__ = "0.1.0"

from mlx_audio_tpu_torch import dsp
from mlx_audio_tpu_torch.dsp import istft, mel_filters, stft

__all__ = ["dsp", "stft", "istft", "mel_filters", "__version__"]
