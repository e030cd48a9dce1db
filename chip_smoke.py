#!/usr/bin/env python3
"""Drive the PyTorch port (``mlx_audio_tpu_torch``) on one NVIDIA GPU:
Kokoro-82M synthesis, CSM-1B speech through int8 decode (whole and
streamed), Orpheus-3B, OuteTTS-1B and Spark-TTS-0.5B through int8 decode,
Dia-1.6B, Bark, the DAC-44kHz and EnCodec-24kHz codecs, the Vocos vocoder,
Whisper-large-v3-turbo, Voxtral-Mini-3B and Parakeet-TDT-0.6B-v2 speech
to text, the BigVGAN-v2 vocoder, IndexTTS-1.5, the depth-draft probes,
Kokoro-82M, EnCodec, BigVGAN, the int8 LMs (CSM-1B, Orpheus-3B,
OuteTTS-1B, Spark-TTS-0.5B, Voxtral-Mini-3B), Dia-1.6B, Bark,
Whisper-large-v3-turbo, Parakeet-TDT-0.6B-v2 and IndexTTS-1.5 in bf16, the
entry points a user calls (native checkpoints, the TTS CLI, the HTTP
server's batched /tts and its /stt), a speech-to-speech session (Whisper,
a chat LM and Kokoro behind /ws/sts and the WebRTC bridge), CSM-1B read
from an HF-transformers directory, Mimi's own loaders, the SilentCipher
watermark and the S3 speech tokenizers, and check its hand-written CUDA
kernels and their bf16 variants.

    python3 chip_smoke.py

Phases; the failure of any one ends the script with a non-zero exit:

1. print the card (``nvidia-smi``), torch and CUDA versions; build the eight
   kernels from ``mlx_audio_tpu_torch/csrc/`` with ``nvcc`` for ``sm_90a``
   into ``mlx_audio_tpu_torch/csrc/build/`` (one ``nvcc`` each, together);
2. hold every kernel against its plain PyTorch version on the card at the
   main paths' shapes (float32, TF32 off): the three Kokoro-82M kernels
   (``lstm`` at Kokoro's H=256 on its cluster route, whose
   ``cudaOccupancyMaxActiveClusters`` it prints, and on its row route at
   H=100 and at EnCodec-24kHz's H=512, B=1 with T=150 and 225, B=4 with
   T=150; ``dilated_conv1d`` and ``banded_conv1d`` compute in 3xTF32 on the
   tensor cores and print that bound beside the float32-FMA one, and their
   error against a float64 run of the plain version),
   ``quantized_matmul`` at every projection of CSM-1B's path (int8, 1 to
   128 rows; int4 at the llama-1B ones) and ``depth_draft`` on a full
   llama-100M pack (greedy and sampled, tokens equal), and the three
   depth-draft probes at the full probe shape (4 layers x 1024 x 28672,
   chunks of 4096, 30 steps; every mode in int8, the stream modes in bf16
   too; results equal); time kernel, plain version and one library call
   (``quantized_matmul``'s operands cold in L2), check that every row of
   a 2-, 8- and 32-row ``quantized_matmul`` equals the 1-row call on it bit
   for bit, and print where the kernel and the dequantize-and-matmul path
   cross; print ``depth_draft``'s times beside those of the kernel as first
   ported (``PERF.md`` row 5), its bound and the floor of its synchronisation (one
   launch that passes as many grid-wide synchronisations and does no work,
   three ways);
   then run the probes' entry point (``scripts/probe_depth.py``, every
   mode, int8 and bf16); the bf16 variants of ``lstm``, ``dilated_conv1d``
   and ``banded_conv1d`` (counted as ``<name>_bf16``) at Kokoro's bench
   shapes (``lstm`` at B=32, T=512 and 1300, H=256, both directions, and
   the conv shapes above), BigVGAN-v2's resblocks, EnCodec's H=512 row
   route, Whisper's conv1 (batch 1 and 4) and Dia's DAC-44kHz resblocks
   ([1, 11008, 384], K=7, d = 1, 3, 9): each output within one bf16 step of a float64 run of the plain
   version (``kernels.bf16_steps``), timed beside cuDNN's conv or
   ``torch.nn.LSTM`` on the same bf16 operands, bound at 989 TFLOP/s dense
   bf16 or 2-byte traffic; and ``quantized_matmul``'s bf16 variant
   (``quantized_matmul_bf16``) at every int8 projection and tied head of
   CSM-1B, Orpheus-3B, OuteTTS-1B, Spark-TTS-0.5B and Voxtral-Mini-3B, 1
   and 4 rows (and CSM's 32-row verify), with bf16 and with float32 scales:
   each output within one bf16 step of float64, timed beside a cuBLAS bf16
   matmul against the weight dequantized ahead of time, its rows bitwise
   independent of their batch;
3. run Kokoro-82M's ``Model.generate``, ``Model.generate_batch`` and
   ``Model.synthesize_batch`` at full width with seeded random weights;
4. run the Kokoro bench-shaped pass (batch 8, phoneme bucket 512, frame
   bucket 1300, durations capped at alternating 2/3) through
   ``duration_stage`` and ``synthesis_stage``, median of 5 synced
   iterations, then one more iteration under ``torch.profiler``;
5. CSM-1B at full width (llama-1B backbone, llama-100M depth decoder,
   Mimi with 32 codebooks, seeded random weights, ``quantize_model`` to
   int8 in groups of 128, a stub tokenizer, 2 s of seeded reference audio):
   greedy ``generate`` without and with ``enable_spec_decode()`` (the frames
   must be equal), the same with ``stream=True`` (chunks of 3, 4, then 6
   frames through the stateful Mimi decoder; frames equal, audio within
   1e-3; time to first audio and each chunk's real-time factor),
   ``generate_batch`` of 4 texts, and one sampled ``generate`` with spec
   decode; ``quantized_matmul`` held against its
   plain version on the operands of its first call at each (rows, I, O)
   these runs gave it; then a timed breakdown (prefill, frame loop, Mimi)
   and a ``torch.profiler`` view of the spec-decode frame loop, with
   ``quantized_matmul``'s calls and device time in it; then the same CSM
   cast with ``cast_lm(torch.bfloat16)`` (the RoPE tables, Mimi and the
   watermark float32): greedy ``generate`` without and with spec decode
   (the draft packed again from the bf16 weights, fed float32 caches), the
   frames equal or the first differing code a near-tie of the plain run's
   logits (the winner within one bf16 step), counted;
6. Orpheus-3B at the published widths (hidden 3072, 28 layers, 24/8 heads,
   vocabulary 156 940, tied head; seeded random weights with the stop and
   audio-marker rows of the embedding at 0; int8 in groups of 64; a stub
   tokenizer; SNAC-24kHz): greedy ``generate`` of 70 tokens,
   ``generate_batch`` of 4 texts, one sampled ``generate`` at the defaults;
   a one-prompt ``generate_tokens_batch`` must equal ``generate_tokens``,
   and each batch row's tokens shared with its one-row run are printed;
   ``quantized_matmul`` held against its plain version on the path's
   operands; tokens/s at batch 1 and 4, the SNAC decode, the real-time
   factor, peak memory, a profile of 16 decode steps.  Then DAC-44kHz (the
   published config, seeded random weights): encode and decode 3 s, with
   the route of every conv printed, ``compress`` and ``decompress`` 3 s,
   and the same 3 s encoded and decoded on the CPU with the same weights:
   codes equal, the encoder's latents and the audio within the tolerance.
   Before DAC, the Orpheus model cast with ``.to(torch.bfloat16)`` (SNAC
   too): a greedy ``generate``;
7. OuteTTS-1B at the published widths (hidden 2048, 16 layers, 32/8
   heads, vocabulary 134 400, tied head; seeded random weights arranged so
   that greedy decoding emits c1, c2 code pairs and never stops; int8 in
   groups of 64; a stub tokenizer; the 24 kHz speech DAC): greedy
   ``generate`` of 240 tokens, the same streamed (its chunks cover the
   whole run), ``generate_batch`` of 4 texts, one sampled ``generate`` at
   the defaults; a one-prompt ``generate_tokens_batch`` must equal the
   greedy run; ``quantized_matmul`` held against its plain version on the
   path's operands; tokens/s at batch 1 and 4, the DAC decode, the
   real-time factor, a profile of 16 steps; then the model cast with
   ``.to(torch.bfloat16)`` (its DAC too): a greedy ``generate``.  Then
   Dia-1.6B at the published
   widths (float32, seeded random weights with channel 0's EOS logit held
   at 0; DAC-44kHz): greedy ``generate`` of 100 steps (0.81 s of audio),
   ``generate_batch`` of 4 texts, a one-text ``generate_batch`` (codes
   equal to the greedy run's), the encoder bucket against all 1024
   positions (codes equal), one sampled ``generate`` at the defaults; the
   encoder time, decode steps/s at batch 1 and 4, the DAC decode, the
   real-time factor, launches a step, a profile of 16 steps, peak memory;
   then the greedy codes fed, teacher-forced, through the same weights on
   the card and on the CPU for 4 steps: logits within the tolerance; then
   the model cast with ``.to(torch.bfloat16)`` (the DAC given at
   construction too): a greedy ``generate`` whose DAC decode launches both
   conv kernels' bf16 variants only;
8. EnCodec-24kHz (the published config, seeded random weights, its
   codebooks and output scale arranged on a seeded clip): encode and decode
   3 s at 6 kbps, timed, with the route of every conv and ``lstm``'s
   launches by route printed (4, all on the row route), and the same clip
   through the same weights on the CPU: codes equal, audio within the
   tolerance; after Bark, the same EnCodec cast to bf16 on the clip in
   bf16: 4 ``lstm_bf16`` launches on the row route and nothing else, held
   to its plain version, and against the CPU in bf16 (codes equal away
   from a one-step near-tie, the card's codes decoded on both within a
   relative RMS).  Bark at the published widths (three 24-layer GPTs of width
   1024, 1.09 B parameters, f32; seeded random weights with the early stop's
   logit held near -10; a stub tokenizer; that EnCodec): a greedy-like
   ``generate`` (76 semantic tokens, every stage at temperature 1e-6: 1.52
   s of audio), ``generate_batch`` of 4 texts, whose rows' semantic tokens
   must equal their one-row runs, one sampled ``generate`` at the default
   temperature, and a repeat of the greedy-like run through
   ``generate_batch([text])`` (a determinism check: tokens equal, audio
   within the tolerance); every run must make its whole semantic budget; semantic and coarse steps/s at batch 1 and
   4, the fine stage, EnCodec's decode, the real-time factor, a profile of
   16 semantic steps, peak memory; the greedy tokens fed, teacher-forced,
   through the card's weights and the CPU's: logits within the tolerance.
   After the EnCodec's bf16 run, Bark cast with ``.to(torch.bfloat16)``: a
   greedy-like ``generate`` whose EnCodec decode launches ``lstm_bf16`` on
   the row route only, its audio float32.
   Vocos-mel-24kHz (the published config, seeded random weights):
   ``Vocos(audio)`` on 3 s and ``decode`` of its mel, timed, with the conv
   routes, against the CPU within the tolerance.  ``lstm`` must launch on
   the EnCodec and Bark paths, on the row route only, and is held to its
   plain version on the operands those paths gave it;
9. Spark-TTS-0.5B at the published widths (the Qwen2-0.5B LM: hidden 896,
   24 layers, 14/2 heads, vocabulary 166 000, tied head, qkv bias; seeded
   random weights, the embedding at a twentieth of the init's scale and
   its two stop rows at 0; int8 in
   groups of 64; BiCodec at ``DEFAULT_BICODEC_CONFIG``; wav2vec2 at
   wav2vec2-large-xlsr-53's widths; a stub tokenizer whose ``decode`` reads
   a run as 32 global and 110 semantic tokens): greedy control-mode
   ``generate`` (110 semantic tokens, 2.2 s at 16 kHz), ``generate_batch`` of
   4 texts (each row's tokens shared with its one-row run printed), one
   sampled ``generate`` at the defaults, a greedy voice-clone ``generate``
   from a seeded 6 s clip; a one-prompt ``generate_tokens_batch`` must
   equal the greedy run; the route of every conv printed;
   ``quantized_matmul`` and both conv kernels must launch in every run (the
   wave generator's second block, C = 384 at 6 000 rows: banded at d = 1,
   dilated at d = 3 and 9), ``lstm`` and ``depth_draft`` never, and the
   three are held to their plain versions on the path's operands; then, on
   the card and through the same weights on the CPU, ``tokenize`` of the
   clip (features within the tolerance, tokens equal wherever the CPU's
   winner beats its runner-up by more than 1e-5, the near-ties counted),
   ``detokenize`` of the greedy tokens (audio within the tolerance) and the
   int8 LM's teacher-forced logits over 8 steps (within the tolerance);
   tokens/s at batch 1 and 4, the time of ``tokenize`` and ``detokenize``,
   the real-time factor, peak memory, a profile of 16 decode steps; then
   the model cast with ``.to(torch.bfloat16)`` (BiCodec too; its float32
   speaker embedding promotes the wave generator to float32 as in the JAX
   package): a greedy control-mode ``generate``;
10. Whisper-large-v3-turbo at the published dims (128 mels, a 32-layer
   1280-wide encoder, a 4-layer decoder, vocabulary 51 866; f32, seeded
   random weights arranged so that every decode runs its 224 tokens and
   ends its window on a lone timestamp; a stub encoding with the
   multilingual vocabulary's ids): ``generate`` of a seeded 60 s clip
   (greedy, word timestamps: two seek windows), ``decode`` of a batch of 4
   windows, a beam search (beam 5) on one window; ``dilated_conv1d`` (its
   conv1, K = 3, [B, 3000, 128] -> 1280) must launch once in every encode
   and ``banded_conv1d``, ``lstm``, ``depth_draft`` and ``quantized_matmul``
   never, and it is held to its plain version on the path's operands; the
   log-mel, the encoder output and 8 teacher-forced decoder steps held to
   the same weights on the CPU, and the first window's tokens to the
   CPU's greedy choice (equal where its margin exceeds 1e-5, the
   near-ties counted); encoder ms a window at batch 1 and 4, tokens/s at
   batch 1 and 4, beam steps/s, the real-time factor, peak memory, a
   profile of 16 decode steps; then the model cast with
   ``.to(torch.bfloat16)``: an encode at batch 4 and a greedy ``decode`` of
   one window, each launching ``dilated_conv1d_bf16`` once (conv1) and no
   other kernel, encoder ms a window and tokens/s beside float32's.  Then
   Voxtral-Mini-3B (the audio tower at
   ``AudioConfig``'s defaults, f32; the published Llama text config with
   head_dim 128, int8 in groups of 64, the head's end-of-speech row at 0):
   greedy ``generate`` of a 30 s clip (40 tokens) and of a 60 s clip (two
   windows as one batch); ``dilated_conv1d`` once an encode,
   ``quantized_matmul`` 211 times a decode step (and once for the prompt's
   head), both held to their plain versions on the path's operands;
   tokens/s, the real-time factor, peak memory, a profile of 16 decode
   steps; then the
   model cast with ``.to(torch.bfloat16)``: one 30 s window, the float32
   log-mel and audio embeddings promoting through the tower and the
   prefill as in the JAX package (the float32 ``dilated_conv1d`` and
   ``quantized_matmul`` once each, for the prompt), every decode step in
   bf16, held to the same weights in float32 on the card;
11. Parakeet-TDT-0.6B-v2 at the published widths (128 mels; a 24-layer
   FastConformer, d_model 1024, 8 heads, ff 4096, conv kernel 9,
   subsampling by 8 with 256 channels; a 2-layer 640-wide prediction net
   over 1024 pieces and the blank; a 640-wide joint with 5 TDT durations;
   f32, seeded random weights, the joint's blank row at 0 so that every
   label step emits): ``generate`` of a seeded 60 s clip read from a wav
   file the phase writes with the port's ``save_audio`` (30 s chunks, 15 s
   overlap: three full chunks in one batched encoder pass, the tail alone),
   ``decode`` of one 30 s window at batch 1 and 4, and a CTC head on the
   same encoder (``decode`` of one window); none of this repository's
   kernels may launch and every conv must take the library route; the
   log-mel, encoder output, 8 teacher-forced joint steps and the CTC
   log-probs held to the same weights on the CPU, every label and
   duration of the window's decode to the CPU's choice (equal where its
   margin exceeds 1e-5); encoder ms a window, the label loop's steps/s,
   the real-time factor, peak memory, a profile of one decode; then the
   model and its CTC head cast with ``.to(torch.bfloat16)``: the TDT and
   the CTC ``decode`` of one window, the encoder float32 by promotion as in
   the JAX package, no kernel of ours.  Then BigVGAN-v2-24kHz-100band (the published config, f32, seeded random
   weights): a 10 s mel (938 frames) at batch 1 and 2; ``dilated_conv1d``
   must launch 26 times and ``banded_conv1d`` 10 times a forward (the
   768- and 384-channel resblocks), no other kernel ever, each held to its
   plain version on the path's operands; the audio held to the CPU's; ms a
   forward, the real-time factor, peak memory, a profile of one forward;
   then the same model cast to bf16 on the mel in bf16: 26
   ``dilated_conv1d_bf16`` and 10 ``banded_conv1d_bf16`` launches and
   nothing else, each held to its plain version (one bf16 step of
   float64), the audio against the same weights in float32 on the card
   (relative RMS);
12. IndexTTS-1.5-class widths (``scripts/bench_indextts.py``: a 1280 x 24
   GPT-2 over 8 194 mel codes, a 512 x 6 conformer and a 32-latent
   perceiver, the speaker-conditioned BigVGAN from 1536 channels at 1024x;
   f32, seeded random weights, the mel head's stop row at 0 so that every
   run makes its budget, a stub tokenizer), from a seeded 3 s clip as
   ``ref_audio``: greedy ``generate`` of 255 codes (256 latents, 10.92 s),
   ``generate_batch`` of 4 prompts of different lengths (one vocoder call
   at batch 4) and the single runs of its first two rows (codes equal,
   audio within the tolerance), a sampled ``generate`` twice with one seed (it repeats);
   every vocoder call launches ``dilated_conv1d`` 26 times and
   ``banded_conv1d`` 10 times (the 768- and 384-channel resblocks) and no
   other kernel of ours, each held to its plain version on the path's
   operands; the log-mel, conditioning latents, speaker embedding, the
   teacher-forced latents and logits of the prompt and all 255 steps and
   the vocoder's audio held to the same weights on the CPU, the codes to
   the CPU's argmax (equal where its margin exceeds 1e-5); log-mel,
   conditioning and prefill ms, decode steps/s at batch 1 and 4, vocoder
   ms a call, ``generate``'s real-time factor, peak memory, profiles of 32
   decode steps and of one vocoder call (where the trace holds fewer
   ``dilated_conv1d`` events than launches, of two calls in one window);
   then the model cast with ``.to(torch.bfloat16)``: a greedy
   ``generate`` whose decode steps run over bf16 caches while the
   conditioning, the prompt and the vocoder run in float32 by promotion,
   as in the JAX package (the float32 conv kernels, 26 and 10 launches,
   no bf16 variant);
13. Kokoro-82M cast with ``.to(torch.bfloat16)`` at ``bench.py``'s own
   shape and dtype (batch 32, 512 phonemes, 1300 frames, durations capped
   at alternating 2/3, reference and speed in bf16): one iteration with
   every conv and ``lstm`` launch held to its plain version on the path's
   operands (one bf16 step of float64), then the median of 5 synced
   iterations, audio-s/s beside phase 4's float32 figure, peak memory, one
   profiled iteration; ``dilated_conv1d_bf16`` 21, ``banded_conv1d_bf16``
   36 and ``lstm_bf16`` 12 launches a synthesis and no other kernel; then
   one bf16 ``generate`` (and ``synthesize_batch``) on the card against
   the same bf16 weights on the CPU, the source's draws made on the CPU
   for both: durations equal, audio within a relative RMS past sample
   2400;
14. the entry points a user calls (``entry_point_runs``): Kokoro-82M at
   its published config written with ``utils.loader.save_checkpoint`` and
   read back with ``load_model`` (every tensor equal bit for bit), a bf16
   copy from the convert CLI (``tts.convert.main``, on the card), the TTS
   CLI (``tts.generate.main``) on that directory (its wav equal to the
   loaded model's own ``generate`` within one 16-bit step), then the HTTP
   server (``server.create_app`` behind aiohttp's test server on
   loopback): one lone /tts request, 8 concurrent ones that the
   ``DynamicBatcher`` runs as one batch of 8 rows (``lstm``,
   ``dilated_conv1d`` and ``banded_conv1d`` launching as in one phase 4
   synthesis, each held to its plain version on the batch's own operands;
   each row's wav against its text alone past sample 2400, within 2e-3 but
   for one source-phase flip's 2 400 samples, by at most 0.2),
   and 5 under ``max_batch=6`` (one batch of exactly 5 rows); then
   Whisper-large-v3-turbo in bf16 written as a native checkpoint (about 1.6
   GB), loaded bit for bit by the server, and /stt of a served wav: every
   encode launches ``dilated_conv1d_bf16`` once and nothing else of ours,
   and the tokens equal the written model's own ``generate``; the save and
   load seconds, the batch's and the lone request's wall seconds, peak
   memory; then Kokoro's ``prewarm`` (``kokoro_prewarm_runs``) in a fresh
   process on the written checkpoint, at 128 phonemes: its seconds, stage
   calls, kernel libraries loaded and launches, then a novel length's first
   and second ``synthesize`` (the first may load no kernel library);
15. one speech-to-speech session on the card, as ``scripts/bench_sts.py``
   drives it (``sts_session_runs``): phase 14's bf16 Whisper checkpoint
   behind a greedy English shim, a chat LM at Qwen2.5-0.5B-Instruct's
   widths in bf16 (written as an HF-layout directory and read with
   ``ChatLM.from_pretrained``), phase 14's bf16 Kokoro with its duration
   head at the trained rate; the server's ``prewarm`` (Kokoro's stage grid
   at 128 phonemes, a chat turn, 5 STT lengths),
   2 turns through /ws/sts (2 s of speech, real-time silence frames, then
   "flush") and one through the WebRTC bridge at 48 kHz: every turn gives
   its transcript, a chunk a reply sentence and the final reply; each
   chunk equals a direct ``generate`` of its sentence, each reply a direct
   ``respond_stream``; every conv and lstm launch is held to its plain
   version; the chat LM's bf16 logits within 3e-2 of float32's on the
   card; per turn its launches, speech end and flush to the first audio
   byte, and the STT, chat and TTS wall seconds;
16. the CSM remainder and the S3 tokenizers (``csm_hf_runs``,
   ``silentcipher_runs``, ``s3_runs``): the phase-5 CSM-1B rebuilt from its
   seed at ``CSM_HF_CONFIG`` (sesame/csm-1b's config.json; its digest must
   be phase 5's), written as an HF-transformers directory (the tied audio
   table as the depth decoder's copy only, the embedded Mimi's q and k in
   HF's rotate-half order) and read by ``load_model(..., strict=True)``:
   every tensor bit for bit; then int8 in groups of 128 and spec decode: a
   greedy ``generate`` whose frames must equal phase 5's spec frames, with
   ``quantized_matmul`` and ``depth_draft`` launching and held to their
   plain versions on the path's operands; its Mimi written as a kyutai/mimi
   HF directory and as a Kyutai file and read back by
   ``Mimi.from_pretrained``: state bit for bit, codes of a seeded 2 s clip
   equal, audio within 1e-5; SilentCipher at ``SilentCipherConfig()``
   written as a torch checkpoint (``module.`` prefixes, OIHW convs, one
   ``dec_c`` array) and read by ``load_watermarker``; the CSM output marked
   by the model's own ``_watermark`` through ``$MLX_AUDIO_TPU_SILENTCIPHER``
   and verified; ``encode_wav`` and ``decode_wav`` of the CSM output and of
   a seeded 2 s clip against the same weights on the CPU (perturbation
   within 1e-4 relative RMS, messages equal, the clip's SDR at least 30
   dB); S3 v1 (50 Hz) and v2 (25 Hz) at ``S3Config()``, written as MLX
   community directories and read by ``from_pretrained``, on a batch of a
   30 s and a 21.3 s seeded clip: v1 launches ``dilated_conv1d`` once an
   encode (held to its plain version), v2 nothing of ours; codes and
   lengths against the CPU's, a code differing only at a near-tie of the
   CPU's margin (below 1e-4), at most 1% of them; the directories' sizes,
   write and load seconds, frames a wall second, encode and decode ms;
17. the device mesh on one card (``mesh_runs``): phase 16's int8 CSM-1B's
   ``generate_batch`` of 4 texts, greedy, MESH_FRAMES frames, under no
   mesh, under dp=2,tp=2 over [cuda:0] x 4 and under tp=2 alone: frames
   equal to the unsharded run's, ``quantized_matmul`` held to its plain
   version at every shape each run gave it (the shards' O/2 and I/2 among
   them), its launches a frame printed; phase 14's Kokoro-82M checkpoint's
   ``synthesize_batch`` of the 8 served texts under no mesh and under dp=4
   over [cuda:0] x 4: durations equal, rows within phase 14's row bounds,
   the dp run's conv and lstm launches 4x the unsharded run's and held to
   their plain versions; the same batch over two processes joined by
   ``parallel.distributed`` (gloo, both on cuda:0), 4 rows each: durations
   equal, rows within phase 14's row bounds, each process's wall seconds
   against the unsharded run's; the server set up from ``--mesh dp=0``
   (dp=1 on one card) serving one /tts;
18. ``export.py`` (``export_runs``, in a process of its own started after
   phase 4, beside phases 5-17, whose result phase 18 reads): each kind of
   program exported with ``torch.export`` at published widths, saved,
   loaded back with
   ``load_program`` and run on the card against the live port on the same
   inputs, its kernels' launches against the live run's, with its export
   and load seconds, graph nodes, custom-op nodes and artifact bytes:
   Kokoro-82M at batch 1, 512 phonemes and 1300 frames against
   ``synthesize_batch`` fed the same source draws (durations equal, audio
   within 1e-5; 12 ``lstm``, 21 ``dilated_conv1d`` and 36 ``banded_conv1d``
   nodes, launched as many times), loaded again in a fresh process that
   imports only the op module and the loader (no ``models`` or ``codec``
   module imported; the same launches), which runs while the rest
   export; CSM-1B at sesame/csm-1b's widths with its backbone and depth
   decoder cut to EXPORT_LAYERS layers (tracing and saving take time in
   proportion to graph nodes and weight bytes), int8, spec decode: its
   prefill and a chunk of EXPORT_CSM_CHUNK greedy frames against
   ``_prefill``, ``first_frame`` and ``_frame_chunk`` (frames equal;
   ``quantized_matmul`` and ``depth_draft`` launches equal, one
   ``depth_draft`` node in the chunk); its whole Mimi's batch decode
   (within 1e-5) and the stateful stream decode in 3 chunks (within 1e-4
   of the batch decode, 1e-5 of the live frame-by-frame decode);
   Orpheus-3B int8 cut to EXPORT_LAYERS layers, a greedy session of a
   prefill and two chunks against ``generate_tokens_batch`` (tokens and
   launches equal), and its whole SNAC decode (within 1e-5);
   Whisper-large-v3-turbo with EXPORT_LAYERS encoder and decoder layers,
   its greedy window program against ``decode`` (tokens equal, one
   ``dilated_conv1d`` node and launch);
19. print one ``{"kernels": [...]}`` line, then the device line last.

Phase 2 holds ``quantized_matmul`` at Orpheus-3B's, OuteTTS-1B's,
Spark-TTS-0.5B's and Voxtral-Mini-3B's shapes too (int8, groups of 64, 1
and 4 rows), and the conv kernels at DAC-44kHz's, DAC-24kHz's and
BiCodec's routed resblock shapes (K=7, d = 1, 3, 9), at Whisper's conv1
(batch 1 and 4) and S3 v1's (batch 2), and at BigVGAN-v2's resblocks ([1, 3752, 768] and [1,
15008, 384], K = 3, 7, 11 at d = 1, 3, 5) and IndexTTS-1.5's ([1, 2408,
768] and [1, 19264, 384], the same K and d).  Launch counters are set to 0
just before each run of the probes' entry point and of phases 3 to 18, and
read just after:
each kernel of a run's path must have launched in it (Orpheus:
``quantized_matmul``; DAC's encode and decode: both conv kernels; OuteTTS
and Spark: all three; Dia's DAC decode: both conv kernels; EnCodec's encode
and decode and Bark's EnCodec decode: ``lstm``; Whisper's and Voxtral's
encodes: ``dilated_conv1d``; Voxtral's decode steps: ``quantized_matmul``;
BigVGAN's forwards and IndexTTS's runs: both conv kernels; Parakeet's
runs: none; the HF-loaded CSM's spec generate: ``quantized_matmul`` and
``depth_draft``; S3 v1's encode: ``dilated_conv1d`` alone, v2's: none; the bf16 runs of Kokoro, BigVGAN and EnCodec: their bf16
variants only; the bf16 LM runs: ``quantized_matmul_bf16``, ``depth_draft``
on CSM's spec path, both conv kernels' bf16 variants in OuteTTS's DAC, and
of the kernels with a bf16 variant no float32 one but where the JAX
package promotes to float32 too (Spark's wave generator, Voxtral's
prompt); Dia's DAC decode: both conv kernels' bf16 variants; Bark's
EnCodec decode: ``lstm_bf16``; Whisper's bf16 encodes:
``dilated_conv1d_bf16``; IndexTTS's bf16 run: the float32 conv kernels
(its vocoder promotes); Parakeet's bf16 run: none; each of their launches
is held to its plain version on the path's operands; the runs of Spark
(against the CPU), Voxtral, Dia, Bark, Whisper, Parakeet and IndexTTS
(against float32 on the card) are held, over 4 teacher-forced steps, to
the same bf16 weights run in float32: logits within a relative RMS,
tokens equal wherever the float32 run's winner beats its runner-up by
more than one bf16 step of its logit (Dia's CFG codes: by more than 3 RMS
of the two runs' CFG-logit difference there), the near-ties counted; each
bf16 run prints its rate beside its float32 run's),
Kokoro's ``lstm`` launches only on the cluster route, EnCodec's and Bark's
only on the row route.
Needs
one CUDA card and the repository checkout around this file; it imports
nothing of JAX.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, dense TF32 and int8 tensor-core operations, and HBM3
# bandwidth.  The port's kernels run float32 FMAs, depth_draft int8 dot
# products, and the two conv kernels 3xTF32: three TF32 products a float32
# multiply-add, so their float32 rate is a third of the TF32 peak.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
# dense bf16 tensor-core operations: the bound of the bf16 variants, whose
# operands move as 2-byte values
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12

TOL = {"atol": 1e-4, "rtol": 1e-4}  # as tests/test_pallas_ops.py uses

KERNEL_INFO = {
    "lstm": ("mlx_audio_tpu_torch/csrc/lstm.cu",
             "mlx_audio_tpu/nn/pallas_ops.py:70"),
    "dilated_conv1d": ("mlx_audio_tpu_torch/csrc/dilated_conv1d.cu",
                       "mlx_audio_tpu/nn/pallas_ops.py:259"),
    "banded_conv1d": ("mlx_audio_tpu_torch/csrc/banded_conv1d.cu",
                      "mlx_audio_tpu/nn/pallas_ops.py:353"),
    "quantized_matmul": ("mlx_audio_tpu_torch/csrc/quantized_matmul.cu",
                         "mlx_audio_tpu/nn/pallas_ops.py:170"),
    "depth_draft": ("mlx_audio_tpu_torch/csrc/depth_draft.cu",
                    "mlx_audio_tpu/nn/pallas_depth.py:424"),
    "probe_depth": ("mlx_audio_tpu_torch/csrc/probe_depth.cu",
                    "scripts/probe_depth.py:63"),
    "probe_vpu": ("mlx_audio_tpu_torch/csrc/probe_vpu.cu",
                  "scripts/probe_depth.py:148"),
    "probe_auto": ("mlx_audio_tpu_torch/csrc/probe_auto.cu",
                   "scripts/probe_depth.py:177"),
}
# the bf16 variants: each built from its float32 kernel's source, standing
# in for the same TPU kernel (which the JAX package runs in bf16 too)
for _name in ("lstm", "dilated_conv1d", "banded_conv1d", "quantized_matmul"):
    KERNEL_INFO[f"{_name}_bf16"] = KERNEL_INFO[_name]
# the kernels each main-path run must launch
KOKORO_KERNELS = ("lstm", "dilated_conv1d", "banded_conv1d")
KOKORO_BF16_KERNELS = tuple(f"{k}_bf16" for k in KOKORO_KERNELS)
PROBE_KERNELS = ("probe_depth", "probe_vpu", "probe_auto")

# Kokoro phoneme alphabet text: the pipeline's fallback G2P passes it
# through unchanged.
TEXT = ("həlˈoʊ wˈɜɹld. ðɪs ɪz ɐ tˈɛst ʌv ðə pˈɔɹt.\n\n"
        "kəkˈoʊɹoʊ spˈiːks ɪn tˈuː pˈæɹəɡɹæfs, ænd ðə sˈɛkənd ɪz lˈɔŋɡɚ "
        "ðæn ðə fˈɜːst wˌʌn.")
BATCH_TEXTS = [
    "ɐ ʃˈɔːɹt wˈʌn.",
    "ðə mˈiːdiəm sˈɛntəns hæz mˈɔːɹ wˈɜːdz ɪn ɪt.",
    "ðɪs ɪz ðə lˈɔŋɡəst ʌv ðə θɹˈiː tˈɛksts, wɪð kˈɑːməz ænd ɐ pˈiːɹiəd.",
]
SPEED = 8.0  # random-weight durations stay inside a few hundred frames
BENCH_BATCH, N_BUCKET, F_BUCKET = 8, 512, 1300  # bench.py's shape


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cpu_twin(build, source: torch.nn.Module) -> torch.nn.Module:
    """``build()`` (a model on the CPU) holding ``source``'s weights, which
    ``load_state_dict`` (strict) sets, every one.  The model's init draws
    (``uniform_`` and ``normal_`` into its empty parameters, about 10 ns a
    weight on one host thread) are skipped while it is built: a reference
    of a large model would spend seconds drawing weights it overwrites."""
    from unittest import mock

    skip = lambda t, *a, **k: t  # noqa: E731
    with mock.patch.object(torch.Tensor, "uniform_", skip), \
            mock.patch.object(torch.Tensor, "normal_", skip):
        twin = build()
    twin.load_state_dict({k: v.cpu() for k, v in source.state_dict().items()})
    return twin


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fns, reps: int) -> float:
    """Device time of one call in ms: at least ``reps`` calls queued behind
    a sleeping kernel, so that the host's launch cost does not leave the
    card idle between them, and CUDA events around the whole run.  ``fns``
    is one call, or a list of the same call on distinct copies of its
    operands, taken in turn (each once per round), so that a call finds
    its operands cold in L2 as a decode step does."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    calls = max(reps, len(fns))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for n in range(calls):
        fns[n % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


# an operand set of at least this many bytes, read in turn, leaves none of
# it in the H100's 50 MB L2 when its turn comes again
COLD_BYTES = 2 * 50 * 2 ** 20


def cold_copies(nbytes: int) -> int:
    return max(1, -(-COLD_BYTES // nbytes))


def bound_ms(flops: float, nbytes: float,
             peak_ops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops = flops / peak_ops
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def build_kernels() -> None:
    from mlx_audio_tpu_torch import build

    t0 = time.perf_counter()
    logs = build.build()
    print(f"built {', '.join(logs)} in {time.perf_counter() - t0:.1f} s "
          f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _lstm_cases(gen):
    from mlx_audio_tpu_torch import build
    from mlx_audio_tpu_torch.nn import kernels

    cs = build.load("lstm").lstm_cluster_size()
    print(f"lstm: H=256 takes the {kernels.lstm_route(256)} route, clusters of "
          f"{cs} CTAs; cudaOccupancyMaxActiveClusters "
          f"{kernels.lstm_max_active_clusters(256)}; H=512 (EnCodec-24kHz) takes "
          f"the {kernels.lstm_route(512)} route", flush=True)
    # Kokoro's two shapes, both directions, on the cluster route; then the
    # row route at one H below Kokoro's and at EnCodec-24kHz's H = 512 (2 s
    # and 3 s at 75 frames a second; Bark's batch of 4), each drawn from a
    # generator of its own so the other kernels' inputs stay as they were
    row_gen = torch.Generator(device="cuda").manual_seed(1)
    enc_gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(8, t, 256, rev, gen) for t in (512, 1300) for rev in (False, True)]
    shapes += [(8, 64, 100, False, row_gen)]
    shapes += [(b, t, 512, False, enc_gen) for b, t in ENCODEC_LSTM_SHAPES]
    for b, t, h, reverse, g in shapes:
        route = kernels.lstm_route(h)
        x_proj = torch.randn(b, t, 4 * h, generator=g, device="cuda") * 0.3
        w_h = torch.randn(4 * h, h, generator=g, device="cuda") * 0.1
        # the reverse direction is the forward recurrence over flipped
        # time, as nn.recurrent.lstm_scan runs it
        xp = (x_proj.flip(1) if reverse else x_proj).contiguous()
        wh = w_h.t().contiguous()
        h0 = torch.zeros(b, h, device="cuda")
        lib = torch.nn.LSTM(4 * h, h, batch_first=True).cuda()
        with torch.no_grad():
            # identity input weight: the library LSTM then computes the
            # same function of x_proj
            lib.weight_ih_l0.copy_(torch.eye(4 * h))
            lib.weight_hh_l0.copy_(w_h)
            lib.bias_ih_l0.zero_()
            lib.bias_hh_l0.zero_()
        yield {
            "kernel": "lstm",
            "shape": f"B={b} T={t} H={h} {'reverse' if reverse else 'forward'}"
                     f" route {route}" + (f" CS={cs}" if route == "cluster" else ""),
            "kernel_fn": lambda xp=xp, wh=wh, h0=h0: kernels.lstm(xp, wh, h0, h0),
            "plain_fn": lambda xp=xp, wh=wh, h0=h0:
                kernels.lstm_plain(xp, wh, h0, h0),
            "library_fn": lambda lib=lib, xp=xp: lib(xp),
            "flops": 2.0 * b * t * h * 4 * h,
            "bytes": 4.0 * (b * t * 4 * h + 4 * h * h + 2 * b * h
                            + 2 * b * t * h + 2 * b * h),
        }


# (B, T) of EnCodec-24kHz's 512-wide LSTMs: Bark's 2 s (150 frames), its
# batch of 4, and phase 8's 3 s clip's encode and decode (225); phase 8's
# Bark runs 76 semantic steps (114 frames) and holds lstm on its own operands
ENCODEC_LSTM_SHAPES = ((1, 150), (1, 225), (4, 150))


# (C, L) of DAC-44kHz's resblocks on a 3 s clip (132 608 samples after the
# hop padding) whose width is a multiple of 128: the encoder's at C = 128,
# 256 and 512, the decoder's at 768 and 384 (C = 64, 96 and 192 take the
# library route)
DAC_RESBLOCKS = ((128, 66304), (256, 16576), (512, 2072), (768, 2072), (384, 16576))
# (C, L) of the 24 kHz speech DAC's (OuteTTS's) decoder resblocks that a
# kernel takes: C = 384 at 40 samples a frame (C = 768 at 8 a frame is
# under 2048 rows, C = 192 and 96 are no multiples of 128: the library), 40
# samples a frame less one: the greedy generate's 142 frames and its
# stream's first chunk of 86, at 300 tokens (phase 7 runs 240 and holds the
# kernels to their plain versions on every operand its decodes give them)
DAC24_RESBLOCKS = ((384, 5679), (384, 3439))
# the same of DAC-44kHz in Dia's greedy generate of 202 steps: 172 frames
# (after the 30-frame drop) at 64 samples a frame, C = 384 (phase 7 runs 100
# steps, 70 frames, and holds the kernels on its own operands)
DIA_RESBLOCKS = ((384, 11008),)
# (C, L) of Spark's BiCodec wave generator that a kernel takes: its second
# block, C = 384 at 40 samples a semantic token, 150 tokens (C = 768 at 8 a
# token is under 2048 rows, C = 192 and 96 are no multiples of 128: the
# library; phase 9 runs 110 tokens, 4400 rows, and holds the kernels on its
# own operands)
SPARK_RESBLOCKS = ((384, 6000),)
# (C, L) of BigVGAN-v2-24kHz's resblocks on a 10 s mel (938 frames) whose
# width is a multiple of 128: 768 channels at 4 samples a frame, 384 at 16
# (its K = 3, 7, 11 at d = 1, 3, 5 each; phase 11 holds the kernels to their
# plain versions on every operand its forwards give them)
BIGVGAN_RESBLOCKS = ((768, 3752), (384, 15008))
# the same of IndexTTS-1.5's conditioned BigVGAN on 301 latents (300 mel
# codes): 768 channels at 8 samples a latent, 384 at 64; K = 3, 7, 11 at d =
# 1, 3, 5 each, every one routed to a kernel (phase 12 runs 256 latents,
# [1, 2048, 768] and [1, 16384, 384], and holds the kernels on its own
# operands)
INDEXTTS_RESBLOCKS = ((768, 2408), (384, 19264))
# (B, L, C, Cout) of Whisper-large-v3-turbo's and Voxtral's conv1 (K = 3,
# 'same'; 128 mels into 1280) in phase 10: one 30 s window, and a batch of 4
WHISPER_STEMS = ((1, 3000, 128, 1280), (4, 3000, 128, 1280))
# the same of S3 v1 at 50 Hz in phase 16: a batch of 2, 3000 mel frames
S3_STEMS = ((2, 3000, 128, 1280),)


def _conv_cases(gen):
    from mlx_audio_tpu_torch.nn.layers import conv1d_route

    cases = [("dilated_conv1d", s + (s[2],), k, d, "") for s, k, d in KOKORO_SHIFTED]
    cases += [("banded_conv1d", s + (s[2],), k, d, "") for s, k, d in KOKORO_BANDED]
    # DAC-44kHz's resblock convs (K=7, d = 1, 3, 9) that take a kernel, on a
    # 3 s clip, and at phase 7's decodes DAC-24kHz's (OuteTTS) and
    # DAC-44kHz's (Dia), each on the kernel its route names
    for codec, blocks in (("DAC-44kHz", DAC_RESBLOCKS), ("DAC-24kHz", DAC24_RESBLOCKS),
                          ("DAC-44kHz, Dia", DIA_RESBLOCKS),
                          ("Spark BiCodec", SPARK_RESBLOCKS)):
        for (c, l), d in itertools.product(blocks, (1, 3, 9)):
            route = conv1d_route(7, c, c, l, d, padding=3 * d)
            if route != "library":
                name = "dilated_conv1d" if route == "shifted" else "banded_conv1d"
                cases.append((name, (1, l, c, c), 7, d, f" ({codec})"))
    for family, blocks in (("BigVGAN-v2", BIGVGAN_RESBLOCKS),
                           ("IndexTTS-1.5", INDEXTTS_RESBLOCKS)):
        for (c, l), k, d in itertools.product(blocks, (3, 7, 11), (1, 3, 5)):
            route = conv1d_route(k, c, c, l, d, padding=(k - 1) * d // 2)
            if route == "library":
                fail(f"{family}'s resblock conv [1, {l}, {c}] K={k} d={d} takes no kernel")
            name = "dilated_conv1d" if route == "shifted" else "banded_conv1d"
            cases.append((name, (1, l, c, c), k, d, f" ({family})"))
    for b, l, c, c_out in WHISPER_STEMS:
        if conv1d_route(3, c, c_out, l, padding=1) != "shifted":
            fail(f"Whisper's conv1 [{b}, {l}, {c}] -> {c_out} does not take dilated_conv1d")
        cases.append(("dilated_conv1d", (b, l, c, c_out), 3, 1, " (Whisper, Voxtral conv1)"))
    for b, l, c, c_out in S3_STEMS:
        if conv1d_route(3, c, c_out, l, padding=1) != "shifted":
            fail(f"S3 v1's conv1 [{b}, {l}, {c}] -> {c_out} does not take dilated_conv1d")
        cases.append(("dilated_conv1d", (b, l, c, c_out), 3, 1, " (S3 v1 conv1)"))
    yield from _conv_case_dicts(gen, cases, torch.float32)


# Kokoro-82M's conv shapes as phase 2 holds its kernels (batch 2 of bench.py's
# frame bucket: [2, 26000, 256] after the first upsampling, [2, 156001, 128]
# after the second): K = 3 on the dilated kernel, K = 7 and 11 on the banded
KOKORO_SHIFTED = tuple([((2, 26000, 256), 3, d) for d in (1, 3, 5)]
                       + [((2, 156001, 128), 3, 1)])
KOKORO_BANDED = (((2, 26000, 256), 7, 1), ((2, 156001, 128), 11, 1),
                 ((2, 26000, 256), 7, 3), ((2, 156001, 128), 11, 3))


def _conv_case_dicts(gen, cases, dtype):
    """Phase 2's case of each (kernel, (B, L, C, Cout), K, d, label): seeded
    operands in ``dtype``; the kernel (the banded one with d > 1 through the
    residue fold), its plain version, cuDNN's conv on the same operands, and
    the plain version in float64.  float32 runs 3xTF32 (its float32-FMA
    bound printed beside), bf16 one bf16 product a multiply-add."""
    import torch.nn.functional as F

    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.nn.layers import _dilated_conv1d_residue

    bf16 = dtype == torch.bfloat16
    size = 2 if bf16 else 4
    for name, (b, l, c, c_out), k, d, label in cases:
        x = (torch.randn(b, l, c, generator=gen, device="cuda") * 0.3).to(dtype)
        w = (torch.randn(k, c, c_out, generator=gen, device="cuda") * 0.05).to(dtype)
        x_ncl = x.transpose(1, 2).contiguous()
        w_lib = w.permute(2, 1, 0).contiguous()
        pad = (k - 1) * d // 2
        if name == "dilated_conv1d":
            def kern(x=x, w=w, d=d):
                return kernels.dilated_conv1d(x, w, d)

            def plain(x=x, w=w, d=d):
                return kernels.dilated_conv1d_plain(x, w, d)
        elif d == 1:
            def kern(x=x, w=w):
                return kernels.banded_conv1d(x, w)

            def plain(x=x, w=w):
                return kernels.banded_conv1d_plain(x, w)
        else:
            def kern(x=x, w=w, d=d):
                return _dilated_conv1d_residue(x, w, d, kernels.banded_conv1d)

            def plain(x=x, w=w, d=d):
                return _dilated_conv1d_residue(x, w, d,
                                               kernels.banded_conv1d_plain)
        yield {
            "kernel": f"{name}_bf16" if bf16 else name,
            "shape": f"[{b}, {l}, {c}]" + (f" -> {c_out}" if c_out != c else "")
                     + f" K={k} d={d}"
                     + (" residue fold" if name == "banded_conv1d" and d > 1 else "")
                     + label + (" bf16" if bf16 else ""),
            "kernel_fn": kern, "plain_fn": plain,
            "library_fn": lambda x=x_ncl, w=w_lib, p=pad, d=d:
                F.conv1d(x, w, None, 1, p, d),
            "flops": 2.0 * b * l * c * c_out * k,
            "bytes": size * (b * l * (c + c_out) + k * c * c_out),
            # the float32 kernels run 3xTF32 on the tensor cores: the
            # float32-FMA bound is printed beside that one; the kernel's error
            # and the plain version's against the plain version in float64
            "peak_ops": PEAK_BF16_FLOPS if bf16 else PEAK_3XTF32_FLOPS,
            "f32_fma_bound": not bf16, "bf16": bf16,
            "float64_fn": (
                (lambda x=x, w=w, d=d: kernels.dilated_conv1d_plain(
                    x.double(), w.double(), d))
                if name == "dilated_conv1d" else
                (lambda x=x, w=w, d=d: _dilated_conv1d_residue(
                    x.double(), w.double(), d, kernels.banded_conv1d_plain))),
        }


# (B, T) of Kokoro-82M's LSTMs at bench.py's batch 32: its phoneme bucket
# (the text and duration encoders) and its frame bucket (F0/N's shared LSTM)
KOKORO_BF16_LSTM_SHAPES = ((32, 512), (32, 1300))


def _bf16_cases(gen):
    """The bf16 variants at the main paths' shapes: lstm at Kokoro-82M's
    bench shapes (H = 256, the cluster route, both directions) and at
    EnCodec-24kHz's H = 512 (the row route), the conv kernels at Kokoro's
    shapes, BigVGAN-v2's resblocks, Whisper's conv1 and Dia's DAC
    resblocks.  Each output must lie within one bf16
    step of a float64 run of the plain version (``kernels.bf16_steps``);
    the library calls are cuDNN's on the same bf16 operands."""
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.nn.layers import conv1d_route

    bf16 = torch.bfloat16
    shapes = [(b, t, 256, rev) for b, t in KOKORO_BF16_LSTM_SHAPES for rev in (False, True)]
    shapes += [(b, t, 512, False) for b, t in ENCODEC_LSTM_SHAPES]
    for b, t, h, reverse in shapes:
        route = kernels.lstm_route(h)
        x_proj = (torch.randn(b, t, 4 * h, generator=gen, device="cuda") * 0.3).to(bf16)
        w_h = (torch.randn(4 * h, h, generator=gen, device="cuda") * 0.1).to(bf16)
        xp = (x_proj.flip(1) if reverse else x_proj).contiguous()
        wh = w_h.t().contiguous()
        h0 = torch.zeros(b, h, device="cuda", dtype=bf16)
        lib = torch.nn.LSTM(4 * h, h, batch_first=True).cuda().to(bf16)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(torch.eye(4 * h))
            lib.weight_hh_l0.copy_(w_h)
            lib.bias_ih_l0.zero_()
            lib.bias_hh_l0.zero_()
        yield {
            "kernel": "lstm_bf16",
            "shape": f"B={b} T={t} H={h} {'reverse' if reverse else 'forward'} route "
                     f"{route} bf16",
            "kernel_fn": lambda xp=xp, wh=wh, h0=h0: kernels.lstm(xp, wh, h0, h0),
            "plain_fn": lambda xp=xp, wh=wh, h0=h0: kernels.lstm_plain(xp, wh, h0, h0),
            "library_fn": lambda lib=lib, xp=xp: lib(xp),
            "flops": 2.0 * b * t * h * 4 * h,
            "bytes": 2.0 * (b * t * 4 * h + 4 * h * h + 2 * b * h
                            + 2 * b * t * h + 2 * b * h),
            "peak_ops": PEAK_BF16_FLOPS, "bf16": True,
            "float64_fn": lambda xp=xp, wh=wh, h0=h0: kernels.lstm_plain(
                xp.double(), wh.double(), h0.double(), h0.double()),
        }
    cases = [("dilated_conv1d", s + (s[2],), k, d, " (Kokoro)") for s, k, d in KOKORO_SHIFTED]
    cases += [("banded_conv1d", s + (s[2],), k, d, " (Kokoro)") for s, k, d in KOKORO_BANDED]
    for (c, l), k, d in itertools.product(BIGVGAN_RESBLOCKS, (3, 7, 11), (1, 3, 5)):
        route = conv1d_route(k, c, c, l, d, padding=(k - 1) * d // 2, dtype=bf16)
        if route == "library":
            fail(f"BigVGAN-v2's resblock conv [1, {l}, {c}] K={k} d={d} takes no bf16 kernel")
        name = "dilated_conv1d" if route == "shifted" else "banded_conv1d"
        cases.append((name, (1, l, c, c), k, d, " (BigVGAN-v2)"))
    # Whisper-large-v3-turbo's conv1 in bf16 (phase 10's bf16 encodes) and
    # DAC-44kHz's decoder resblocks in Dia's bf16 decode (phase 7)
    for b, l, c, c_out in WHISPER_STEMS:
        if conv1d_route(3, c, c_out, l, padding=1, dtype=bf16) != "shifted":
            fail(f"Whisper's conv1 [{b}, {l}, {c}] -> {c_out} takes no dilated_conv1d_bf16")
        cases.append(("dilated_conv1d", (b, l, c, c_out), 3, 1, " (Whisper conv1)"))
    for (c, l), d in itertools.product(DIA_RESBLOCKS, (1, 3, 9)):
        route = conv1d_route(7, c, c, l, d, padding=3 * d, dtype=bf16)
        if route == "library":
            fail(f"Dia's DAC resblock conv [1, {l}, {c}] K=7 d={d} takes no bf16 kernel")
        name = "dilated_conv1d" if route == "shifted" else "banded_conv1d"
        cases.append((name, (1, l, c, c), 7, d, " (DAC-44kHz, Dia)"))
    yield from _conv_case_dicts(gen, cases, bf16)


# (I, O) of every QuantizedLinear on CSM-1B's path (int8 and int4 in groups
# of 128): the llama-1B backbone's and the llama-100M depth decoder's
# projections (q, k, v and o apart), the backbone-to-decoder projection and
# the codebook-0 head (2051 columns, the last tile part empty)
QMM_SHAPES = (((2048, 2048), "llama-1B q, o"), ((2048, 512), "llama-1B k, v"),
              ((2048, 8192), "llama-1B gate, up"), ((8192, 2048), "llama-1B down"),
              ((1024, 1024), "llama-100M q, o"), ((1024, 256), "llama-100M k, v"),
              ((1024, 8192), "llama-100M gate, up"), ((8192, 1024), "llama-100M down"),
              ((2048, 1024), "projection"), ((2048, 2051), "codebook0_head"))
# decode steps (1 row a step, 2 at a frame's first depth step, 4 and 8 in a
# batch of 4), the 32-row verify pass, and enough row counts between them
# and a 128-row prefill to place the kernel's crossover with the plain path
QMM_ROWS = (1, 8, 16, 32, 48, 64, 128)
QMM_ROWS_INT4 = (1, 8, 128)
# Orpheus-3B's, int8 in groups of 64 (mlx-community/orpheus-3b-0.1-ft-8bit):
# the projections of its 28 layers and the tied head, a QuantizedEmbedding's
# as_linear over 156 940 codes; at a decode step of batch 1 and of batch 4
ORPHEUS_QMM_SHAPES = (((3072, 3072), "Orpheus-3B q, o"), ((3072, 1024), "Orpheus-3B k, v"),
                      ((3072, 8192), "Orpheus-3B gate, up"), ((8192, 3072), "Orpheus-3B down"),
                      ((3072, 156_940), "Orpheus-3B tied head"))
ORPHEUS_QMM_ROWS = (1, 4)
# OuteTTS-1B's (OuteAI/Llama-OuteTTS-1.0-1B), int8 in groups of 64: the
# projections of its 16 layers and the tied head over 134 400 tokens
OUTETTS_QMM_SHAPES = (((2048, 2048), "OuteTTS-1B q, o"), ((2048, 512), "OuteTTS-1B k, v"),
                      ((2048, 8192), "OuteTTS-1B gate, up"),
                      ((8192, 2048), "OuteTTS-1B down"),
                      ((2048, 134_400), "OuteTTS-1B tied head"))
# Spark-TTS-0.5B's LM (Qwen2-0.5B), int8 in groups of 64: the projections of
# its 24 layers (down in 3 parts) and the tied head over 166 000 tokens
SPARK_QMM_SHAPES = (((896, 896), "Spark q, o"), ((896, 128), "Spark k, v"),
                    ((896, 4864), "Spark gate, up"), ((4864, 896), "Spark down"),
                    ((896, 166_000), "Spark tied head"))


# Voxtral-Mini-3B's LM (mistralai/Voxtral-Mini-3B-2507: hidden 3072, 32/8
# heads of 128, intermediate 8192), int8 in groups of 64: the projections
# of its 30 layers and the untied head over 131 072 tokens
VOXTRAL_QMM_SHAPES = (((3072, 4096), "Voxtral q"), ((3072, 1024), "Voxtral k, v"),
                      ((4096, 3072), "Voxtral o"), ((3072, 8192), "Voxtral gate, up"),
                      ((8192, 3072), "Voxtral down"), ((3072, 131_072), "Voxtral head"))


# CSM-1B's shards under tp=2 (phase 17): the column-parallel q, k, v, gate
# and up halve O, the row-parallel o and down halve I (down's 4 parts of
# 2 048 columns fall 2 a shard); at 2 rows a step (dp=2) and 4 (tp=2 alone)
CSM_TP2_QMM_SHAPES = (((2048, 1024), "llama-1B q shard"), ((2048, 256), "llama-1B k, v shard"),
                      ((1024, 2048), "llama-1B o shard"),
                      ((2048, 4096), "llama-1B gate, up shard"),
                      ((4096, 2048), "llama-1B down shard"),
                      ((1024, 512), "llama-100M q shard"), ((1024, 128), "llama-100M k, v shard"),
                      ((512, 1024), "llama-100M o shard"),
                      ((1024, 4096), "llama-100M gate, up shard"),
                      ((4096, 1024), "llama-100M down shard"))
CSM_TP2_QMM_ROWS = (2, 4)


def _qmm_shapes():
    """(family, (I, O), role, group size, bits, row counts) of every
    quantized_matmul case."""
    for io, role in QMM_SHAPES:
        yield "csm", io, role, 128, 8, QMM_ROWS
        if role.startswith("llama-1B"):
            yield "csm", io, role, 128, 4, QMM_ROWS_INT4
    for io, role in CSM_TP2_QMM_SHAPES:
        yield "csm_tp2", io, role, 128, 8, CSM_TP2_QMM_ROWS
    for io, role in ORPHEUS_QMM_SHAPES:
        yield "orpheus", io, role, 64, 8, ORPHEUS_QMM_ROWS
    for io, role in OUTETTS_QMM_SHAPES:
        yield "outetts", io, role, 64, 8, ORPHEUS_QMM_ROWS
    for io, role in SPARK_QMM_SHAPES:
        yield "spark", io, role, 64, 8, ORPHEUS_QMM_ROWS
    for io, role in VOXTRAL_QMM_SHAPES:
        yield "voxtral", io, role, 64, 8, ORPHEUS_QMM_ROWS


def _quantized(gen, i, o, gs, bits):
    from mlx_audio_tpu_torch.nn.layers import Linear
    from mlx_audio_tpu_torch.nn.quantize import QuantizedLinear

    lin = Linear(i, o, bias=False)
    lin.weight.data = torch.randn(o, i, generator=gen, device="cuda") * i ** -0.5
    return QuantizedLinear.from_linear(lin, group_size=gs, bits=bits)


def _qmm_cases(gen):
    """quantized_matmul at every (I, O) of CSM-1B's path in int8, and at
    the llama-1B ones in int4, groups of 128; at Orpheus-3B's in int8,
    groups of 64.  Timed calls take the codes (and the library's dense
    weight) from enough distinct copies to be cold in L2.  The library call
    is one cuBLAS matmul against the weight dequantized ahead of time."""
    from mlx_audio_tpu_torch.nn import kernels

    for family, (i, o), role, gs, bits, row_counts in _qmm_shapes():
        q = _quantized(gen, i, o, gs, bits)
        dense = q.to_linear().weight.data.cuda()
        qbytes = q.weight.numel() + 4 * (q.scales.numel() + q.biases.numel())
        sets = [(q.weight.clone(), q.scales.clone(), q.biases.clone())
                for _ in range(cold_copies(qbytes))]
        denses = [dense.clone() for _ in range(cold_copies(4 * dense.numel()))]
        del dense
        parts, _ = kernels.quantized_matmul_parts(i, o, gs, q.packed)
        for b in row_counts:
            x = torch.randn(b, i, generator=gen, device="cuda")
            kern = [lambda a=(x, *w, gs, q.packed): kernels.quantized_matmul(*a)
                    for w in sets]
            plain = [lambda a=(x, *w, gs, q.packed): kernels.quantized_matmul_plain(*a)
                     for w in sets]
            lib = [lambda x=x, w=w: x @ w.t() for w in denses]
            yield {
                "kernel": "quantized_matmul", "queued": True, "rows": b,
                "bits": bits, "io": (i, o), "family": family,
                "shape": f"B={b} I={i} O={o} int{bits} gs{gs} parts {parts} ({role})",
                "kernel_fn": kern[0], "plain_fn": plain[0], "library_fn": lib[0],
                "timed": (kern, plain, lib),
                "flops": 2.0 * b * i * o,
                "bytes": qbytes + 4 * b * (i + o),
            }


# the bf16 variant at every int8 shape above: 1 and 4 rows (a decode step
# at batch 1 and 4), and CSM's 32-row verify
QMM_BF16_ROWS = (1, 4)
QMM_BF16_CSM_ROWS = (1, 4, 32)


def _qmm_bf16_cases(gen):
    """quantized_matmul's bf16 variant at every int8 projection and tied head
    of CSM-1B (groups of 128), Orpheus-3B, OuteTTS-1B, Spark-TTS-0.5B and
    Voxtral-Mini-3B (groups of 64): bf16 x with bf16 scales and biases (a
    quantized model cast to bf16) and with float32 ones (a bf16 model
    quantized after its cast).  Each output within one bf16 step of a
    float64 run of the plain version; timed with the operands cold in L2
    beside the plain version (float32 dequantize and matmul) and one
    cuBLAS bf16 matmul against the weight dequantized to bf16 ahead of
    time; bound by the code, scale and bias bytes (2 a bf16 value) and the
    2-byte x and y, or by the products at the dense bf16 peak."""
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.nn.quantize import _affine_dequantize

    bf16 = torch.bfloat16
    for family, (i, o), role, gs, bits, _ in _qmm_shapes():
        if bits != 8 or family == "csm_tp2":  # the shards run in float32 here
            continue
        q = _quantized(gen, i, o, gs, bits)
        parts, _ = kernels.quantized_matmul_parts(i, o, gs, q.packed)
        for sdt in (bf16, torch.float32):
            s, z = q.scales.to(sdt), q.biases.to(sdt)
            qbytes = q.weight.numel() + s.element_size() * (s.numel() + z.numel())
            sets = [(q.weight.clone(), s.clone(), z.clone())
                    for _ in range(cold_copies(qbytes))]
            dense = _affine_dequantize(q.weight, s.float(), z.float(), gs).to(bf16)
            denses = [dense.clone() for _ in range(cold_copies(2 * dense.numel()))]
            del dense
            sname = "bf16" if sdt == bf16 else "float32"
            for b in (QMM_BF16_CSM_ROWS if family == "csm" else QMM_BF16_ROWS):
                x = torch.randn(b, i, generator=gen, device="cuda").to(bf16)
                kern = [lambda a=(x, *w, gs, q.packed): kernels.quantized_matmul(*a)
                        for w in sets]
                plain = [lambda a=(x, *w, gs, q.packed): kernels.quantized_matmul_plain(*a)
                         for w in sets]
                lib = [lambda x=x, w=w: x @ w.t() for w in denses]
                yield {
                    "kernel": "quantized_matmul_bf16", "queued": True, "rows": b,
                    "bits": bits, "io": (i, o), "family": family, "scales": sname,
                    "shape": f"B={b} I={i} O={o} int{bits} gs{gs} parts {parts} bf16 x, "
                             f"{sname} scales ({role})",
                    "kernel_fn": kern[0], "plain_fn": plain[0], "library_fn": lib[0],
                    "timed": (kern, plain, lib),
                    "flops": 2.0 * b * i * o, "bytes": qbytes + 2 * b * (i + o),
                    "peak_ops": PEAK_BF16_FLOPS, "bf16": True,
                    "float64_fn": lambda a=(x.double(), *sets[0], gs, q.packed):
                        kernels.quantized_matmul_plain(*a),
                }
            del sets, denses
        del q
        torch.cuda.empty_cache()


def qmm_row_independence(gen) -> None:
    """Each row of a 2-, 8- and 32-row quantized_matmul equals, bit for bit,
    the 1-row call on that row (the kernel sums in one order whatever the
    row count), at every int8 shape of CSM-1B (groups of 128), of
    Orpheus-3B, OuteTTS-1B, Spark-TTS-0.5B and Voxtral-Mini-3B (groups of
    64), and at llama-1B's q, o in int4; in float32, and in bf16 (bf16 x
    and scales; at CSM-1B's shapes bf16 x with float32 scales too: one
    rounding after the same sums)."""
    from mlx_audio_tpu_torch.nn import kernels

    shapes = [(io, 128, 8) for io, _ in QMM_SHAPES] + [(QMM_SHAPES[0][0], 128, 4)]
    shapes += [(io, 64, 8) for io, _ in ORPHEUS_QMM_SHAPES + OUTETTS_QMM_SHAPES
               + SPARK_QMM_SHAPES + VOXTRAL_QMM_SHAPES]
    bf16 = torch.bfloat16
    csm_int8 = {io for io, _ in QMM_SHAPES}
    for (i, o), gs, bits in shapes:
        q = _quantized(gen, i, o, gs, bits)
        x32 = torch.randn(32, i, generator=gen, device="cuda")
        variants = [("float32", x32, q.scales, q.biases)]
        if bits == 8:
            variants.append(("bf16", x32.to(bf16), q.scales.to(bf16), q.biases.to(bf16)))
            if (i, o) in csm_int8 and gs == 128:
                variants.append(("bf16 x, float32 scales", x32.to(bf16), q.scales, q.biases))
        for label, x, s, z in variants:
            w = (q.weight, s, z, gs, q.packed)
            ones = torch.cat([kernels.quantized_matmul(x[r:r + 1], *w) for r in range(32)])
            for rows in (2, 8, 32):
                got = kernels.quantized_matmul(x[:rows], *w)
                if not torch.equal(got, ones[:rows]):
                    n = int((got != ones[:rows]).any(1).sum())
                    fail(f"quantized_matmul ({label}) I={i} O={o} int{bits} gs{gs}: {n} "
                         f"of {rows} rows differ from the 1-row calls on them")
            del ones
        del q, x32, variants
    print("quantized_matmul rows independent: every row of 2-, 8- and 32-row "
          "calls equals the 1-row call bit for bit, at "
          + ", ".join(f"I={i} O={o} int{b} gs{g}" for (i, o), g, b in shapes)
          + "; in float32, in bf16 at every int8 shape, and with bf16 x and float32 "
          "scales at CSM-1B's int8 shapes", flush=True)


def _draft_cases(gen):
    """depth_draft on a full llama-100M pack (CSM's depth decoder: 4 layers,
    Dm 1024, F 8192, 8 query and 2 key/value heads of 128, 31 heads of 2051
    codes), greedy and at temperature 0.9 / top-k 50 on fixed noise."""
    from mlx_audio_tpu_torch.models.sampling import gumbel
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.nn.pallas_depth import (depth_draft_plain, draft_exchanges,
                                                     draft_inputs)

    packed, kc, vc, c1, vocab = draft_inputs(gen)
    n_steps, vpad = packed.heads.shape[:2]
    weights = sum(t.numel() * t.element_size() for t in (
        packed.wqkv, packed.sqkv, packed.wo, packed.so, packed.wgu, packed.sgu,
        packed.wdown, packed.sdown, packed.norms, packed.final_norm))
    head = (packed.heads[0].numel() + 4 * packed.sheads[0].numel()
            + 2 * packed.emb_proj.shape[-1])
    macs = (packed.wqkv.numel() + packed.wo.numel() + packed.wgu.numel()
            + packed.wdown.numel() + packed.heads[0].numel())
    for temp, top_k in ((0.0, 0), (0.9, 50)):
        noise = (gumbel((n_steps, vpad), gen, "cuda") if temp > 0
                 else torch.zeros(n_steps, vpad, device="cuda"))
        args = (packed, kc, vc, c1, noise, vocab, temp, top_k)
        yield {
            "kernel": "depth_draft", "exact": True, "queued": True,
            "plain_host_bound": True,  # thousands of small launches
            "shape": f"llama-100M, {n_steps} steps, temp {temp} top_k {top_k}",
            "kernel_fn": lambda a=args: kernels.depth_draft(*a),
            "plain_fn": lambda a=args: depth_draft_plain(*a),
            "library_fn": None,
            # every step streams all layers' int8 weights and scales, one
            # head and one embedding row; the caches, noise and tokens once
            "flops": 2.0 * macs * n_steps,
            "bytes": (n_steps * (weights + head) + 2 * 4 * kc.numel()
                      + 4 * noise.numel() + 4 * n_steps),
            "peak_ops": PEAK_INT8_OPS,
            "exchanges": draft_exchanges(packed), "temp": temp,
        }


# depth_draft as first ported (PERF.md row 5), on the same card: greedy and
# at temperature 0.9 / top-k 50
DRAFT_FIRST_PORT_MS = {0.0: 5.508, 0.9: 5.728}


def draft_summary(records) -> None:
    """depth_draft's times beside the first port's, the bound and the floor
    of its synchronisation: one launch of the draft's shape that passes as
    many synchronisations of every CTA as the draft makes and does no work,
    by the draft's own exchange of tagged words, by a grid barrier of one
    counter, and by cooperative_groups' grid.sync()."""
    from mlx_audio_tpu_torch.nn import kernels

    n = records[0]["exchanges"]
    dev = torch.device("cuda")
    floor = {mode: median_ms(lambda m=mode: kernels.depth_draft_sync_only(n, m, dev), 5)
             for mode in kernels.DRAFT_SYNC_MODES}
    for r in records:
        r["sync_only_ms"] = floor
    print("depth_draft: " + "; ".join(
        f"{r['shape']}: {r['ms']:.3f} ms (as first ported: "
        f"{DRAFT_FIRST_PORT_MS[r['temp']]:.3f} ms)" for r in records)
        + f"; bound {records[0]['bound_ms']:.4f} ms ({records[0]['bound_by']}); "
        f"sync-only floor, {n} rounds and no work: "
        + ", ".join(f"{m} {ms:.4f} ms" for m, ms in floor.items())
        + f"; on {gpu_line()}", flush=True)


# The depth-draft probes' shape (scripts/probe_depth.py's defaults): one
# draft step streams 4 layers of [1024, 28 * 1024] weights in chunks of 4096
# columns, 30 steps a run
PROBE_LAYERS, PROBE_DM, PROBE_COLS, PROBE_CHUNK, PROBE_STEPS = 4, 1024, 28 * 1024, 4096, 30
# CUDA-core int8 rate, derived: the data sheet's 67 TFLOP/s of float32 FMAs
# is one FMA a lane a clock; one dp4a (4 multiply-adds, 8 operations) a lane
# a clock is assumed, four times that rate
PEAK_DP4A_OPS = 4 * PEAK_F32_FLOPS


def _probe_cases(gen):
    """The three probe kernels at the full probe shape: the stream modes in
    int8 and bf16, mxu and vpu in int8; results equal to the plain
    versions'.  Library calls, each timed once and counted as many times as
    the probe repeats its work: an int64 torch.sum over one step's weights
    (x 30, the stream modes), torch._int_mm of x padded to 32 rows with the
    resident chunk (x 840, mxu), an f32 torch.matmul of x with it (x 840,
    vpu)."""
    from mlx_audio_tpu_torch.nn import kernels

    w8 = torch.randint(-127, 127, (PROBE_LAYERS, PROBE_DM, PROBE_COLS),
                       generator=gen, device="cuda", dtype=torch.int8)
    x = torch.randint(-127, 127, (1, PROBE_DM), generator=gen, device="cuda",
                      dtype=torch.int8)
    x3 = torch.randint(-127, 127, (PROBE_DM // 8, 8, 128), generator=gen,
                       device="cuda", dtype=torch.int8)
    steps, reps = PROBE_STEPS, PROBE_LAYERS * PROBE_COLS // PROBE_CHUNK
    for dtype in (torch.int8, torch.bfloat16):
        w = w8 if dtype == torch.int8 else w8.to(dtype)
        chunked = kernels.chunked_layout(w, PROBE_CHUNK)
        streamed = steps * w.numel() * w.element_size()
        plain = lambda c=chunked: kernels.probe_stream_plain(c, steps)  # noqa: E731
        library = lambda w=w: w.sum(dtype=torch.int64)  # noqa: E731
        name = "int8" if dtype == torch.int8 else "bf16"
        for mode in ("dma", "dmac", "dma8", "dmabig", "auto"):
            if mode == "auto":
                kern = lambda c=chunked: kernels.probe_auto(c, steps)  # noqa: E731
            elif mode == "dma":
                kern = lambda w=w: kernels.probe_depth(w, None, "dma", steps, PROBE_CHUNK)  # noqa: E731
            else:
                kern = lambda c=chunked, m=mode: kernels.probe_depth(c, None, m, steps)  # noqa: E731
            yield {
                "kernel": "probe_auto" if mode == "auto" else "probe_depth",
                "exact": True, "rule": "results equal", "shape": f"{mode} {name}, 4 x 1024 x 28672, 30 steps",
                "kernel_fn": kern, "plain_fn": plain, "library_fn": library,
                "library_repeat": steps, "flops": 0.0, "bytes": float(streamed)}
        del chunked
    chunked = kernels.chunked_layout(w8, PROBE_CHUNK)
    chunk0 = chunked[0].contiguous()
    xvec = x3[:, :, 0].reshape(-1)
    dot_ops = 2.0 * PROBE_DM * PROBE_CHUNK * reps * steps
    x32 = torch.zeros(32, PROBE_DM, device="cuda", dtype=torch.int8)
    x32[0] = x[0]
    yield {
        "kernel": "probe_depth", "exact": True, "rule": "results equal",
        "shape": f"mxu int8, {reps} matvecs [1, 1024] @ [1024, 4096] a step, 30 steps",
        "kernel_fn": lambda: kernels.probe_depth(chunked, x, "mxu", steps),
        "plain_fn": lambda: kernels.probe_dot_plain(chunk0, x, reps * steps),
        "library_fn": lambda: torch._int_mm(x32, chunk0), "library_repeat": reps * steps,
        "flops": dot_ops, "bytes": float(chunk0.numel() + PROBE_DM + 8),
        "peak_ops": PEAK_INT8_OPS}
    xf, cf = xvec.float()[None], chunk0.float()
    w3 = chunk0.reshape(PROBE_DM // 8, 8, PROBE_CHUNK)
    yield {
        "kernel": "probe_vpu", "exact": True, "rule": "results equal",
        "shape": f"vpu int8, {reps} matvecs [1, 1024] @ [1024, 4096] a step, 30 steps",
        "kernel_fn": lambda: kernels.probe_vpu(w3, x3, steps, reps),
        "plain_fn": lambda: kernels.probe_dot_plain(chunk0, xvec, reps * steps),
        "library_fn": lambda: torch.matmul(xf, cf), "library_repeat": reps * steps,
        "flops": dot_ops, "bytes": float(chunk0.numel() + PROBE_DM + 8),
        "peak_ops": PEAK_DP4A_OPS}


def _outputs(res):
    if isinstance(res, torch.Tensor):
        return [res]
    out = []
    for r in res:
        out.extend(_outputs(r))
    return out


def check_kernels() -> dict:
    """Phase 2: every kernel against its plain version at the main path's
    shapes.  Returns per-kernel records for the kernels line."""
    from mlx_audio_tpu_torch.nn import kernels

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16_gen = torch.Generator(device="cuda").manual_seed(3)
    records = {name: [] for name in KERNEL_INFO}
    bad = []
    cases = itertools.chain(_lstm_cases(gen), _conv_cases(gen), _qmm_cases(gen),
                            _draft_cases(gen), _probe_cases(gen), _bf16_cases(bf16_gen),
                            _qmm_bf16_cases(bf16_gen))
    for case in cases:
        name = case["kernel"]
        before = kernels.LAUNCHES[name]
        got = _outputs(case["kernel_fn"]())
        torch.cuda.synchronize()
        if kernels.LAUNCHES[name] == before:
            bad.append(f"{name} {case['shape']}: kernel not launched")
        ref = _outputs(case["plain_fn"]())
        if case.get("bf16"):
            err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
        else:
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        if case.get("bf16"):
            # every output within one bf16 step of the plain version in float64
            exact = _outputs(case["float64_fn"]())
            steps = max(kernels.bf16_steps(g, e) for g, e in zip(got, exact))
            ok = all(g.dtype == torch.bfloat16 for g in got) and steps <= 1.0
            f64_err = max(float((g.double() - e).abs().max()) for g, e in zip(got, exact))
            del exact
        elif case.get("exact"):
            ok = all(torch.equal(g, r) for g, r in zip(got, ref))
        else:
            ok = all(torch.allclose(g, r, **TOL) for g, r in zip(got, ref))
        # short kernels are timed queued (device time); the Kokoro cases keep
        # the per-call median of earlier runs
        timer = queued_ms if case.get("queued") else median_ms
        kern_t, plain_t, lib_t = case.get(
            "timed", (case["kernel_fn"], case["plain_fn"], case["library_fn"]))
        ms = timer(kern_t, 10)
        plain_ms = (median_ms if case.get("plain_host_bound") else timer)(
            plain_t, 3)
        library_ms = None
        if lib_t is not None:
            with torch.no_grad():
                library_ms = timer(lib_t, 10) * case.get("library_repeat", 1)
        bms, by = bound_ms(case["flops"], case["bytes"],
                           case.get("peak_ops", PEAK_F32_FLOPS))
        rec = {"shape": case["shape"], "max_abs_err": err, "ok": ok,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
               "bound_by": by, "library_ms": library_ms,
               **{k: case[k] for k in ("rows", "bits", "io", "family", "exchanges", "temp",
                                       "scales")
                  if k in case}}
        bound = f"bound {bms:.4f} ms ({by})"
        if case.get("f32_fma_bound"):
            rec["bound_f32_fma_ms"] = bound_ms(case["flops"], case["bytes"])[0]
            bound = (f"bound 3xTF32 {bms:.4f} ms ({by}), float32 FMA "
                     f"{rec['bound_f32_fma_ms']:.4f} ms")
        if case.get("bf16"):
            rec["bf16_steps"], rec["max_abs_err_f64"] = steps, f64_err
            bound += (f"; against float64: {f64_err:.3e}, {steps:.3f} bf16 steps "
                      f"(kernel against its bf16 plain version {err:.3e})")
        elif "float64_fn" in case:
            exact = case["float64_fn"]()
            rec["max_abs_err_f64"] = float((got[0].double() - exact).abs().max())
            rec["plain_max_abs_err_f64"] = float((ref[0].double() - exact).abs().max())
            bound += (f"; against float64: kernel {rec['max_abs_err_f64']:.3e}, "
                      f"plain {rec['plain_max_abs_err_f64']:.3e}")
            del exact
        records[name].append(rec)
        lib = "—" if library_ms is None else f"{library_ms:.3f} ms"
        rule = ("within one bf16 step of float64" if case.get("bf16") else
                case.get("rule", "tokens equal") if case.get("exact") else
                f"atol {TOL['atol']}, rtol {TOL['rtol']}")
        print(f"{name:16s} {case['shape']:52s} max_abs_err {err:.3e} "
              f"({rule}) {'ok' if ok else 'DISAGREES'}  kernel {ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms  library {lib}  {bound}", flush=True)
        if not ok:
            bad.append(f"{name} {case['shape']}: max_abs_err {err:.3e}")
        del got, ref, case
        torch.cuda.empty_cache()
    if bad:
        fail("kernel check: " + "; ".join(bad))
    qmm_row_independence(gen)
    qmm_crossover(records["quantized_matmul"])
    draft_summary(records["depth_draft"])
    return records


def qmm_crossover(recs) -> None:
    """Where QuantizedLinear's two paths cross on this card: per int8 shape
    of CSM-1B, the most rows at which the kernel is no slower than the plain path it
    takes above ``KERNEL_MAX_ROWS`` (dequantize, then one matmul)."""
    from mlx_audio_tpu_torch.nn.quantize import KERNEL_MAX_ROWS

    wins = {}
    for r in recs:
        if r["bits"] == 8 and r["family"] == "csm":
            rows = wins.setdefault(r["io"], [])
            if r["ms"] <= r["plain_ms"]:
                rows.append(r["rows"])
    best = {io: max(rows, default=0) for io, rows in wins.items()}
    print("quantized_matmul crossover (int8, most rows at which the kernel is "
          "no slower than dequantize-and-matmul): "
          + ", ".join(f"I={i} O={o}: {n}" for (i, o), n in best.items())
          + f"; every shape: {min(best.values())}; KERNEL_MAX_ROWS "
          f"{KERNEL_MAX_ROWS}", flush=True)


def drive_probes(launches: dict) -> None:
    """The probes' entry point (``mlx_audio_tpu_torch.scripts.probe_depth``)
    at its defaults: every mode in int8, then every mode but mxu in bf16.
    Every stream mode must give one result in both runs (same draws)."""
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.scripts import probe_depth

    stream_sums = set()
    for dtype in ("int8", "bf16"):
        modes = [m for m in probe_depth.MODES if dtype == "int8" or m != "mxu"]
        torch.cuda.synchronize()
        kernels.reset_launches()
        records = probe_depth.run(modes, iters=5, dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        launches[f"probes_{dtype}"] = dict(kernels.LAUNCHES)
        missing = [k for k in PROBE_KERNELS if launches[f"probes_{dtype}"][k] == 0]
        if missing:
            fail(f"probe entry point ({dtype}): kernels never launched: {missing}")
        stream_sums |= {r["checksum"] for r in records if r["mode"] not in ("mxu", "vpu")}
    if len(stream_sums) != 1:
        fail(f"probe entry point: stream modes disagree: {sorted(stream_sums)}")


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------


def drive_entry_points(model, voice_path: str) -> None:
    """Phase 3: the user-facing entry points at full width."""
    results = list(model.generate(TEXT, voice=voice_path, speed=SPEED))
    if len(results) != 2:
        fail(f"generate: expected 2 segments, got {len(results)}")
    for r in results:
        if not (r.samples > 0 and r.samples % 600 == 0
                and np.isfinite(r.audio).all()):
            fail(f"generate: segment {r.segment_idx} has {r.samples} samples")
    batch = model.generate_batch(BATCH_TEXTS, voice=voice_path, speed=SPEED)
    if len(batch) != len(BATCH_TEXTS):
        fail("generate_batch: one result per text expected")
    for r in batch:
        if not (r.samples > 0 and r.samples % 600 == 0
                and np.isfinite(r.audio).all()):
            fail(f"generate_batch: text {r.segment_idx} has {r.samples} samples")
    pack = np.load(voice_path)
    refs = np.stack([pack[len(t) - 1].reshape(-1) for t in BATCH_TEXTS])
    outs = model.synthesize_batch(BATCH_TEXTS, refs, speeds=SPEED)
    for (audio, dur), r in zip(outs, batch):
        frames = int(dur.sum())
        if audio.shape != (frames * 600,) or not np.isfinite(audio).all():
            fail(f"synthesize_batch: {audio.shape} samples for {frames} frames")
        if audio.shape[0] != r.samples:
            fail("synthesize_batch and generate_batch disagree on length")
    print("entry points: generate "
          + ", ".join(f"{r.samples} samples" for r in results)
          + "; generate_batch "
          + ", ".join(f"{r.samples} samples" for r in batch), flush=True)


def bench_runner(model, batch: int = BENCH_BATCH, dtype=torch.float32):
    """The shape bench.py measures, at ``batch`` with the reference and
    speed in ``dtype`` (bench.py feeds them in the model's dtype): returns
    run_once(seed) -> (audio, total, duration-stage seconds,
    synthesis-stage seconds)."""
    from mlx_audio_tpu_torch.models.tts.kokoro.model import (
        duration_stage,
        synthesis_stage,
    )

    rng = np.random.default_rng(0)
    dev = model.device
    input_ids = torch.as_tensor(
        rng.integers(1, model.config.n_token, size=(batch, N_BUCKET)),
        dtype=torch.long, device=dev)
    lengths = torch.full((batch,), N_BUCKET, dtype=torch.long, device=dev)
    ref_s = torch.as_tensor(rng.standard_normal((batch, 256)) * 0.1,
                            dtype=torch.float32, device=dev).to(dtype)
    speed = torch.ones(batch, device=dev, dtype=dtype)
    # alternating 2/3 frames per phoneme: 1280 frames in the 1300 bucket
    caps = 2 + (torch.arange(N_BUCKET, device=dev) % 2)[None, :]

    @torch.no_grad()
    def run_once(seed):
        t0 = time.perf_counter()
        d, pred_dur = duration_stage(model, input_ids, lengths,
                                     ref_s[:, 128:], speed)
        pred_dur = torch.minimum(pred_dur, caps)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        audio, total = synthesis_stage(model, input_ids, lengths, d, pred_dur,
                                       ref_s, F_BUCKET, seed=seed)
        torch.cuda.synchronize()
        return audio, total, t1 - t0, time.perf_counter() - t1

    return run_once


def bench_pass(run_once, iters: int = 5, batch: int = BENCH_BATCH) -> dict:
    """Phase 4 (and 13): one warm-up call, then the median of ``iters``
    synced iterations."""
    audio, total, _, _ = run_once(1_000_001)
    if not (audio.shape == (batch, F_BUCKET * 600)
            and bool(torch.isfinite(audio.float()).all())):
        fail(f"bench pass: audio {tuple(audio.shape)} not finite or misshaped")
    per_iter, stages = [], []
    for i in range(iters):
        t0 = time.perf_counter()
        audio, total, t_dur, t_syn = run_once(i)
        per_iter.append(time.perf_counter() - t0)
        stages.append((t_dur, t_syn))
    audio_s = float(total.sum()) * 600 / 24000
    med = statistics.median(per_iter)
    return {"calls": iters + 1, "audio_seconds_per_iter": audio_s,
            "iter_s": per_iter,
            "median_s": med, "audio_seconds_per_second": audio_s / med,
            "duration_stage_s": statistics.median(t for t, _ in stages),
            "synthesis_stage_s": statistics.median(t for _, t in stages),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


KERNEL_GROUPS = (("lstm_cluster_kernel<__nv_bfloat16>", "lstm_bf16 (this repo)"),
                 ("lstm_row_kernel<__nv_bfloat16>", "lstm_bf16 (this repo)"),
                 ("dilated_conv1d_kernel<__nv_bfloat16", "dilated_conv1d_bf16 (this repo)"),
                 ("banded_conv1d_kernel<__nv_bfloat16>", "banded_conv1d_bf16 (this repo)"),
                 ("lstm_cluster_kernel", "lstm (this repo)"),
                 ("lstm_row_kernel", "lstm (this repo)"),
                 ("dilated_conv1d_kernel", "dilated_conv1d (this repo)"),
                 ("banded_conv1d_kernel", "banded_conv1d (this repo)"),
                 ("gemm", "cuBLAS / cuDNN"), ("xmma", "cuBLAS / cuDNN"),
                 ("conv", "cuBLAS / cuDNN"), ("elementwise", "elementwise"),
                 ("scan", "scan (cumsum)"), ("reduce", "reduction"))


def device_time(prof):
    """From a torch.profiler run: (device-busy us, us from the first kernel's
    start to the last one's end, {kernel name: (ms, launches)})."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (end - start) / 1e3, n + 1)
    if not spans:
        return 0.0, 0.0, {}
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0], by_name


def group_of(name: str, table) -> str:
    """The group of the first key in ``table`` that kernel ``name`` contains,
    else "other"."""
    return next((g for key, g in table if key in name), "other")


def kernel_groups(by_name: dict, table) -> dict:
    """{group: (ms, launches)} of a profile's kernels, each in the group of
    the first key in ``table`` its name contains, else "other"."""
    groups = {}
    for name, (ms, n) in by_name.items():
        group = group_of(name, table)
        g_ms, g_n = groups.get(group, (0.0, 0))
        groups[group] = (g_ms + ms, g_n + n)
    return groups


def profile_pass(run_once) -> None:
    """One bench iteration under torch.profiler: device time by kernel
    group and by kernel, and the device's idle share between the first and
    the last kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once(7)
        wall = time.perf_counter() - t0
    busy, window, by_name = device_time(prof)
    if not by_name:
        print("profile: the profiler recorded no device time (not measured)")
        return
    groups = kernel_groups(by_name, KERNEL_GROUPS)
    device_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"profile of one bench iteration: wall {1e3 * wall:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms of a {window / 1e3:.1f} ms kernel window "
          f"(idle share {1 - busy / window:.4f})")
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {group:28s} {ms:10.2f} ms  {ms / device_ms:7.2%}  {n:6d} launches")
    for name, (ms, n) in top:
        print(f"  {ms:10.2f} ms {n:6d}x  {name[:90]}")


# ---------------------------------------------------------------------------
# phase 5: CSM-1B
# ---------------------------------------------------------------------------

CSM_CONFIG = {"backbone_flavor": "llama-1B", "decoder_flavor": "llama-100M",
              "text_vocab_size": 128_256, "audio_vocab_size": 2051,
              "audio_num_codebooks": 32}
CSM_FRAMES = 13  # 1.04 s of audio a greedy generate: the schedule's 3, 4 and 6
CSM_TEXT = "The port speaks with a borrowed voice."
CSM_BATCH_TEXTS = ["One short line.", "A second line, a little longer.",
                   "Three.", "And the fourth line closes the batch."]
CSM_REF_TEXT = "This is the reference voice."
CSM_KERNEL_GROUPS = (("qmm_kernel", "quantized_matmul (this repo)"),
                     ("depth_draft_kernel", "depth_draft (this repo)"),
                     ("gemm", "cuBLAS"), ("xmma", "cuBLAS"), ("gemv", "cuBLAS"),
                     ("elementwise", "elementwise"), ("reduce", "reduction"),
                     ("index", "gather / scatter"), ("softmax", "softmax"))


class StubTokenizer:
    """Llama-3-sized token ids from characters (no tokenizer files ship)."""

    def encode(self, text: str) -> list:
        return [128_000] + [1_000 + (ord(c) * 7_919) % 120_000 for c in text] + [128_001]


def build_csm():
    from mlx_audio_tpu_torch.models.tts.sesame import Model
    from mlx_audio_tpu_torch.nn.quantize import quantize_model

    t0 = time.perf_counter()
    model = Model(CSM_CONFIG, text_tokenizer=StubTokenizer(), device="cuda")
    hold_extra_codes(model)
    # phase 16 rebuilds these weights and checks them against this digest
    model.source_digest = weights_digest(model)
    quantize_model(model.model, group_size=128, bits=8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nbytes = sum(t.numel() * t.element_size() for t in model.model.state_dict().values())
    print(f"CSM-1B built and quantized (int8, groups of 128) in "
          f"{time.perf_counter() - t0:.1f} s; LM state {nbytes / 1e9:.3f} GB",
          flush=True)
    return model


def _check_results(name, results, frames=None):
    if not results:
        fail(f"{name}: no audio")
    for r in results:
        if not (r.samples == 1920 * r.token_count and r.token_count > 0
                and np.isfinite(r.audio).all()):
            fail(f"{name}: {r.samples} samples for {r.token_count} frames")
        if frames is not None and r.token_count != frames:
            fail(f"{name}: {r.token_count} frames, expected {frames}")


def path_runner(launches: dict, wall: dict):
    """run(name, fn): fn() with the launch counters set to 0 just before it
    and read into launches[name] just after, its wall seconds in
    wall[name]."""
    from mlx_audio_tpu_torch.nn import kernels

    def run(name, fn):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        launches[name] = dict(kernels.LAUNCHES)
        return out

    return run


def record_qmm_calls(path_calls: dict):
    """Route kernels.quantized_matmul through a recorder that keeps the
    operands of its first call at each (rows, I, O, group size, packed, x's
    and the scales' dtypes) in path_calls; returns the kernel's wrapper,
    which the caller puts back."""
    from mlx_audio_tpu_torch.nn import kernels

    qmm = kernels.quantized_matmul

    def recording_qmm(x, codes, scales, biases, group_size, packed=False):
        key = (x.shape[0], x.shape[1], codes.shape[0], group_size, packed,
               str(x.dtype).removeprefix("torch."), str(scales.dtype).removeprefix("torch."))
        if key not in path_calls:
            path_calls[key] = (x.clone(), codes, scales, biases, group_size, packed)
        return qmm(x, codes, scales, biases, group_size, packed)

    kernels.quantized_matmul = recording_qmm
    return qmm


def check_qmm_path(path_calls: dict, qmm, label: str, stats: dict = None) -> float:
    """quantized_matmul against its plain version on the operands a path
    gave it: a float32 call within TOL, a bf16 one (the bf16 variant)
    within one bf16 step of the plain version in float64.  Fails past them,
    returns the largest error against the plain version; ``stats`` gets
    the bf16 calls' largest error in bf16 steps."""
    from mlx_audio_tpu_torch.nn import kernels

    path_err, steps, bad = 0.0, 0.0, []
    for key, args in sorted(path_calls.items()):
        got, ref = qmm(*args), kernels.quantized_matmul_plain(*args)
        err = float((got.float() - ref.float()).abs().max())
        path_err = max(path_err, err)
        if args[0].dtype == torch.bfloat16:
            n = kernels.bf16_steps(got, kernels.quantized_matmul_plain(
                args[0].double(), *args[1:]))
            steps = max(steps, n)
            ok = got.dtype == torch.bfloat16 and n <= 1.0
        else:
            ok = torch.allclose(got, ref, **TOL)
        if not ok:
            bad.append(f"rows {key[0]} I={key[1]} O={key[2]} {key[5]} x: {err:.3e}")
        del got, ref
    if bad:
        fail(f"quantized_matmul disagrees with its plain version at the {label} "
             "path's shapes: " + "; ".join(bad))
    kinds = sorted({k[5:] for k in path_calls})
    if stats is not None:
        stats["bf16_steps"] = steps
    print(f"quantized_matmul at the {len(path_calls)} (rows, I, O) the {label} "
          f"path gave it, on the path's own operands: max_abs_err "
          f"{path_err:.3e} (float32: atol {TOL['atol']}, rtol {TOL['rtol']}; bf16: one "
          f"bf16 step of float64, the largest {steps:.3f}) ok; (x, scales) dtypes "
          f"{kinds}; rows "
          + ", ".join(str(n) for n in sorted({k[0] for k in path_calls}))
          + "; (I, O) " + ", ".join(f"({i}, {o})" for i, o in
                                   sorted({k[1:3] for k in path_calls})), flush=True)
    return path_err


def record_conv_calls(path_calls: dict):
    """Route kernels.banded_conv1d and kernels.dilated_conv1d through
    recorders that keep the operands of each wrapper's first call at each
    (kernel, B, L, C, Cout, K, dilation) in path_calls (a residue-folded
    dilated conv is recorded at the folded shape banded_conv1d is given; a
    bf16 call under the bf16 variant's name); returns the two wrappers,
    which the caller puts back."""
    from mlx_audio_tpu_torch.nn import kernels

    banded, dilated = kernels.banded_conv1d, kernels.dilated_conv1d

    def keep(name, x, w, d):
        if x.dtype == torch.bfloat16:
            name = f"{name}_bf16"
        key = (name, *x.shape, w.shape[2], w.shape[0], d)
        if key not in path_calls:
            path_calls[key] = (x.clone(), w.clone(), d)

    def recording_banded(x, w):
        keep("banded_conv1d", x, w, 1)
        return banded(x, w)

    def recording_dilated(x, w, dilation=1):
        keep("dilated_conv1d", x, w, dilation)
        return dilated(x, w, dilation)

    kernels.banded_conv1d, kernels.dilated_conv1d = recording_banded, recording_dilated
    return banded, dilated


def _per_kernel(conv_calls: dict) -> dict:
    names = sorted({key[0] for key in conv_calls} | {"banded_conv1d", "dilated_conv1d"})
    return {name: sum(key[0] == name for key in conv_calls) for name in names}


def check_conv_path(path_calls: dict, wrappers, label: str) -> dict:
    """Each conv kernel against its plain version on the operands a path
    gave it: float32 within TOL; a bf16 variant within one bf16 step of the
    plain version in float64 (``kernels.bf16_steps``).  Fails past them,
    returns each kernel's largest error against its plain version (and a
    bf16 variant's largest in bf16 steps, under "<name> steps")."""
    from mlx_audio_tpu_torch.nn import kernels

    banded, dilated = wrappers
    errs, bad = {"banded_conv1d": 0.0, "dilated_conv1d": 0.0}, []
    for key, (x, w, d) in sorted(path_calls.items()):
        name = key[0]
        if name.startswith("banded_conv1d"):
            got = banded(x, w)

            def plain(a, b):
                return kernels.banded_conv1d_plain(a, b)
        else:
            got = dilated(x, w, d)

            def plain(a, b, d=d):
                return kernels.dilated_conv1d_plain(a, b, d)
        ref = plain(x, w)
        err = float((got.float() - ref.float()).abs().max())
        errs[name] = max(errs.get(name, 0.0), err)
        if x.dtype == torch.bfloat16:
            exact = plain(x.double(), w.double())
            steps = kernels.bf16_steps(got, exact)
            errs[f"{name} steps"] = max(errs.get(f"{name} steps", 0.0), steps)
            ok = steps <= 1.0
            del exact
        else:
            ok = torch.allclose(got, ref, **TOL)
        if not ok:
            bad.append(f"{name} {list(x.shape)} K={w.shape[0]} d={d}: {err:.3e}")
        del got, ref
        torch.cuda.empty_cache()
    if bad:
        fail(f"the conv kernels disagree with their plain versions at the {label} "
             "path's shapes: " + "; ".join(bad))
    print(f"conv kernels at the {len(path_calls)} shapes the {label} path gave them, "
          f"on the path's own operands: max_abs_err {json.dumps(errs)} (float32: atol "
          f"{TOL['atol']}, rtol {TOL['rtol']}; bf16: one bf16 step of float64) ok; "
          + ", ".join(
              f"{k[0]} [{k[1]}, {k[2]}, {k[3]}] K={k[5]} d={k[6]}"
              for k in sorted(path_calls)), flush=True)
    return errs


def record_lstm_calls(path_calls: dict):
    """Route kernels.lstm through a recorder that keeps the operands of its
    first call at each (B, T, H) in path_calls; returns the wrapper, which
    the caller puts back."""
    from mlx_audio_tpu_torch.nn import kernels

    lstm = kernels.lstm

    def recording_lstm(x_proj, wh, h0, c0):
        key = (x_proj.shape[0], x_proj.shape[1], h0.shape[1])
        if key not in path_calls:
            path_calls[key] = tuple(t.clone() for t in (x_proj, wh, h0, c0))
        return lstm(x_proj, wh, h0, c0)

    kernels.lstm = recording_lstm
    return lstm


def check_lstm_path(path_calls: dict, lstm, label: str) -> float:
    """The lstm kernel against its plain version on the operands a path gave
    it: float32 within TOL, bf16 within one bf16 step of the plain version
    in float64; fails past them, returns the largest error against the
    plain version."""
    from mlx_audio_tpu_torch.nn import kernels

    path_err, bad = 0.0, []
    for key, args in sorted(path_calls.items()):
        got, ref = lstm(*args), kernels.lstm_plain(*args)
        got, ref = (got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2])
        err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
        path_err = max(path_err, err)
        if args[0].dtype == torch.bfloat16:
            exact = kernels.lstm_plain(*(a.double() for a in args))
            exact = (exact[0], exact[1], *exact[2])
            steps = max(kernels.bf16_steps(g, e) for g, e in zip(got, exact))
            ok = steps <= 1.0
            print(f"lstm_bf16 B={key[0]} T={key[1]} H={key[2]} ({label}): {steps:.3f} "
                  "bf16 steps from the plain version in float64", flush=True)
        else:
            ok = all(torch.allclose(g, r, **TOL) for g, r in zip(got, ref))
        if not ok:
            bad.append(f"B={key[0]} T={key[1]} H={key[2]}: {err:.3e}")
    if bad:
        fail(f"lstm disagrees with its plain version at the {label} path's "
             "shapes: " + "; ".join(bad))
    print(f"lstm at the {len(path_calls)} (B, T, H) the {label} path gave it, on the "
          f"path's own operands ({', '.join(kernels.lstm_route(k[2]) for k in sorted(path_calls))}"
          f" route): max_abs_err {path_err:.3e} (float32: atol {TOL['atol']}, rtol "
          f"{TOL['rtol']}; bf16: one bf16 step of float64) ok; " + ", ".join(f"B={b} T={t} H={h}"
                                             for b, t, h in sorted(path_calls)), flush=True)
    return path_err


def route_recorder(routes: dict):
    """Route nn.layers.conv1d_route through a recorder counting each conv's
    (route, C, Cout, L, K, dilation, stride, groups) in routes; returns the
    original, which the caller puts back."""
    from mlx_audio_tpu_torch.nn import layers

    route_fn = layers.conv1d_route

    def recording_route(k, c, c_out, l, dilation=1, stride=1, groups=1,
                        padding=0, dtype=torch.float32):
        route = route_fn(k, c, c_out, l, dilation, stride, groups, padding, dtype)
        key = (route, c, c_out, l, k, dilation, stride, groups)
        routes[key] = routes.get(key, 0) + 1
        return route

    layers.conv1d_route = recording_route
    return route_fn


def print_routes(label: str, routes: dict) -> None:
    by_route = {}
    for (route, c, c_out, l, k, d, s, g), n in sorted(routes.items()):
        by_route.setdefault(route, []).append(
            f"{n}x C={c}->{c_out} L={l} K={k} d={d}" + (f" s={s}" if s > 1 else "")
            + (f" groups={g}" if g > 1 else ""))
    for route, convs in by_route.items():
        calls = sum(int(c.split("x")[0]) for c in convs)
        print(f"{label} conv route {route}: {len(convs)} shapes, {calls} calls: "
              + "; ".join(convs), flush=True)


def csm_runs(model, launches: dict) -> dict:
    """The entry points: greedy generate without and with spec decode (the
    frames must be equal), generate_batch, sampled generate with spec."""
    from mlx_audio_tpu_torch.nn import kernels

    ref = (np.random.default_rng(0).standard_normal(48_000) * 0.1).astype(np.float32)
    kw = dict(ref_audio=ref, ref_text=CSM_REF_TEXT,
              max_audio_length_ms=CSM_FRAMES * 80)
    decoded = []
    decode = model.mimi.decode

    def recording_decode(codes):
        decoded.append(codes.clone())
        return decode(codes)

    model.mimi.decode = recording_decode
    streamed_codes = []
    decode_stateful = model.mimi.decode_frames_stateful

    def recording_stateful(codes, state):
        streamed_codes.append(codes.clone())
        return decode_stateful(codes, state)

    model.mimi.decode_frames_stateful = recording_stateful

    def stream_run():
        t0, out = time.perf_counter(), []
        for r in model.generate(CSM_TEXT, temperature=0.0, stream=True, **kw):
            out.append((r, time.perf_counter() - t0))
        return out

    path_calls = {}
    qmm = record_qmm_calls(path_calls)
    wall = {}
    run = path_runner(launches, wall)
    try:
        plain = run("csm_generate", lambda: list(
            model.generate(CSM_TEXT, temperature=0.0, **kw)))
        model.model.enable_spec_decode()
        model.model.spec_stats = [0, 0]
        spec = run("csm_generate_spec", lambda: list(
            model.generate(CSM_TEXT, temperature=0.0, **kw)))
        accept = model.model.spec_stats[:]
        stream = run("csm_generate_spec_stream", stream_run)
        batch = run("csm_generate_batch", lambda: model.generate_batch(
            CSM_BATCH_TEXTS, temperature=0.0, **kw))
        sampled = run("csm_generate_spec_sampled", lambda: list(
            model.generate(CSM_TEXT, temperature=0.9, top_k=50, seed=3, **kw)))
    finally:
        model.mimi.decode = decode
        model.mimi.decode_frames_stateful = decode_stateful
        kernels.quantized_matmul = qmm
    _check_results("csm generate", plain, CSM_FRAMES)
    _check_results("csm generate (spec)", spec, CSM_FRAMES)
    _check_results("csm generate_batch", batch)
    _check_results("csm generate (spec, sampled)", sampled)
    if not torch.equal(decoded[0], decoded[1]):
        n = int((decoded[0] != decoded[1]).sum())
        fail(f"csm: greedy frames differ with spec decode ({n} codes)")
    stream_info = check_stream(stream, streamed_codes, decoded[1], spec[0].audio)
    for name, need in (("csm_generate", ("quantized_matmul",)),
                       ("csm_generate_spec", ("quantized_matmul", "depth_draft")),
                       ("csm_generate_spec_stream", ("quantized_matmul", "depth_draft")),
                       ("csm_generate_batch", ("quantized_matmul",)),
                       ("csm_generate_spec_sampled", ("quantized_matmul", "depth_draft"))):
        missing = [k for k in need if launches[name][k] == 0]
        if missing:
            fail(f"{name}: kernels never launched: {missing}")
    path_err = check_qmm_path(path_calls, qmm, "CSM")
    print(f"csm: greedy frames equal with and without spec decode "
          f"({CSM_FRAMES} frames x 32 codebooks); draft accepted "
          f"{accept[0]} of {accept[1]} tokens ({accept[0] / max(accept[1], 1):.4f}); "
          f"wall s: " + ", ".join(f"{k} {v:.3f}" for k, v in wall.items())
          + "; generate_batch frames "
          + ", ".join(str(r.token_count) for r in batch), flush=True)
    return {"accept": accept, "wall": wall, "qmm_path_err": path_err,
            "qmm_path_shapes": len(path_calls), "stream": stream_info,
            "spec_codes": decoded[1].cpu(), "digest": model.source_digest}


# the first chunk, the ramp chunk, then streaming_interval 0.5 s = 6 frames
STREAM_SCHEDULE = (3, 4) + (6,) * 10


def check_stream(stream, streamed_codes, whole_codes, whole_audio) -> dict:
    """The streamed greedy run against the whole one: chunk sizes 3, 4, then
    6; the same frames; audio within atol 1e-3.  Prints the time to first
    audio and each chunk's frames, wall seconds and real-time factor."""
    sizes = [r.token_count for r, _ in stream]
    want, left = [], CSM_FRAMES
    for n in STREAM_SCHEDULE:
        if left <= 0:
            break
        want.append(min(n, left))
        left -= n
    if sizes != want:
        fail(f"csm stream: chunks of {sizes} frames, expected {want}")
    frames = torch.cat([c[..., :n] for c, n in zip(streamed_codes, sizes)], dim=-1)
    if not torch.equal(frames, whole_codes):
        n = int((frames != whole_codes).sum()) if frames.shape == whole_codes.shape else -1
        fail(f"csm stream: streamed frames differ from the whole generate's ({n} codes)")
    audio = np.concatenate([r.audio for r, _ in stream])
    if audio.shape != whole_audio.shape or not np.isfinite(audio).all():
        fail(f"csm stream: audio {audio.shape}, whole {whole_audio.shape}")
    err = float(np.abs(audio - whole_audio).max())
    if err > 1e-3:
        fail(f"csm stream: audio differs from the whole generate's by {err:.3e}")
    ends = [t for _, t in stream]
    walls = [ends[0]] + [b - a for a, b in zip(ends, ends[1:])]
    rtf = [w / (n * 0.08) for w, n in zip(walls, sizes)]
    steady = sum(walls[1:]) / (0.08 * sum(sizes[1:]))
    print(f"csm stream (batch 1, greedy, spec decode, int8, streaming_interval "
          f"0.5): time to first audio {ends[0]:.4f} s; chunks (frames, wall s, RTF) "
          + ", ".join(f"({n}, {w:.4f}, {x:.4f})" for n, w, x in zip(sizes, walls, rtf))
          + f"; after the first chunk RTF {steady:.4f}; frames equal to the whole "
          f"generate's, audio max abs diff {err:.3e} (atol 1e-3); on {gpu_line()}",
          flush=True)
    return {"ttfa_s": ends[0], "chunk_frames": sizes, "chunk_wall_s": walls,
            "chunk_rtf": rtf, "steady_rtf": steady, "audio_err": err}


def csm_breakdown(model) -> dict:
    """One spec-decode batch-1 generation through the model's own steps,
    synced between them: prefill, frame loop, Mimi; then a profiled frame
    loop."""
    from torch.profiler import ProfilerActivity, profile

    from mlx_audio_tpu_torch.models.tts.sesame import Segment
    from mlx_audio_tpu_torch.nn import kernels

    ref = (np.random.default_rng(1).standard_normal(48_000) * 0.1).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prompt = model._prompt(CSM_TEXT, [Segment(0, CSM_REF_TEXT, ref)], 0, True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        caches, pad_len, last_h = model._prefill([prompt], CSM_FRAMES)
        first = model.model.first_frame(last_h, 0.0, 0, model.generator)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rest = model._frame_chunk(caches, pad_len, first, CSM_FRAMES - 1, 0.0, 0)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        codes = torch.cat([first[None], rest]).permute(1, 2, 0)
        audio = model.mimi.decode(codes)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    audio_s = audio.shape[-1] / 24_000
    out = {"ref_encode_s": t1 - t0, "prefill_s": t2 - t1, "frame_loop_s": t3 - t2,
           "mimi_decode_s": t4 - t3, "frames": CSM_FRAMES,
           "frames_per_s": (CSM_FRAMES - 1) / (t3 - t2),
           "real_time_factor": (t4 - t0) / audio_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("csm breakdown (batch 1, greedy, spec decode, int8): " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in out.items()),
        flush=True)

    with torch.no_grad():
        caches, pad_len, last_h = model._prefill([prompt], CSM_FRAMES)
        first = model.model.first_frame(last_h, 0.0, 0, model.generator)
        model._frame_chunk(caches, pad_len, first, 2, 0.0, 0)  # warm
        torch.cuda.synchronize()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model._frame_chunk(caches, pad_len, first, 4, 0.0, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        qmm_calls = kernels.LAUNCHES["quantized_matmul"]
    busy, window, by_name = device_time(prof)
    if not by_name:
        print("csm profile: the profiler recorded no device time (not measured)")
        return out
    groups = kernel_groups(by_name, CSM_KERNEL_GROUPS)
    device_ms = sum(ms for ms, _ in by_name.values())
    print(f"csm profile of 4 spec-decode frames: wall {1e3 * wall:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms of a {window / 1e3:.1f} ms kernel window "
          f"(idle share {1 - busy / window:.4f}), {sum(n for _, n in by_name.values())} "
          f"kernels")
    for group, (ms, _) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {group:28s} {ms:10.3f} ms  {ms / device_ms:7.2%}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {ms:10.3f} ms {n:6d}x  {name[:90]}")
    part_ms, sum_ms, sums = 0.0, 0.0, 0
    for name, (ms, n) in by_name.items():
        if "qmm_kernel_sum" in name:
            sum_ms, sums = sum_ms + ms, sums + n
        elif "qmm_kernel_part" in name:
            part_ms += ms
    print(f"  quantized_matmul in the 4 frames: {qmm_calls} calls, device "
          f"{part_ms + sum_ms:.3f} ms (part kernels {part_ms:.3f} ms, {sums} "
          f"sums {sum_ms:.3f} ms); on {gpu_line()}")
    out["profile_idle_share"] = 1 - busy / window
    return out


def csm_stream_breakdown(model) -> dict:
    """Where a streamed generate's time goes: the same greedy streamed run
    again (warm), the stateful Mimi decode of CSM_FRAMES frames alone against the
    batch decode of the same codes, and a profile of one 6-frame stateful
    decode."""
    from torch.profiler import ProfilerActivity, profile

    ref = (np.random.default_rng(0).standard_normal(48_000) * 0.1).astype(np.float32)
    t0, ends = time.perf_counter(), []
    for r in model.generate(CSM_TEXT, temperature=0.0, stream=True, ref_audio=ref,
                            ref_text=CSM_REF_TEXT, max_audio_length_ms=CSM_FRAMES * 80):
        ends.append((r.token_count, time.perf_counter() - t0))
    mimi = model.mimi
    gen = torch.Generator(device="cuda").manual_seed(5)
    codes = torch.randint(0, mimi.cfg.quantizer_bins, (1, mimi.cfg.quantizer_nq, CSM_FRAMES),
                          generator=gen, device="cuda")
    times = {}
    for name, fn in (("stateful", lambda: mimi.decode_frames_stateful(codes, mimi.init_state(1))),
                     ("batch", lambda: mimi.decode(codes))):
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t1
    state = mimi.init_state(1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        mimi.decode_frames_stateful(codes[..., :6], state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    busy, window, by_name = device_time(prof)
    out = {"warm_ttfa_s": ends[0][1], "warm_total_s": ends[-1][1],
           "mimi_stateful_ms_per_frame": 1e3 * times["stateful"] / CSM_FRAMES,
           "mimi_batch_ms_per_frame": 1e3 * times["batch"] / CSM_FRAMES}
    print("csm stream breakdown: warm streamed run, time to first audio "
          f"{ends[0][1]:.4f} s, all {sum(n for n, _ in ends)} frames {ends[-1][1]:.4f} s; "
          f"Mimi over {CSM_FRAMES} frames: stateful {times['stateful']:.4f} s "
          f"({out['mimi_stateful_ms_per_frame']:.2f} ms a frame), batch "
          f"{times['batch']:.4f} s; on {gpu_line()}", flush=True)
    if by_name:
        print(f"  profile of a 6-frame stateful decode: wall {1e3 * wall:.1f} ms, "
              f"device busy {busy / 1e3:.2f} ms of a {window / 1e3:.1f} ms window, "
              f"{sum(n for _, n in by_name.values())} kernels")
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"  {ms:10.3f} ms {n:6d}x  {name[:90]}")
        out["mimi_profile_busy_ms"] = busy / 1e3
        out["mimi_profile_wall_ms"] = 1e3 * wall
    return out


# ---------------------------------------------------------------------------
# phase 6: Orpheus-3B int8 and DAC-44kHz
# ---------------------------------------------------------------------------

ORPHEUS_TOKENS = 70  # generated: 10 SNAC frames of 7 tokens, 0.85 s of audio
ORPHEUS_FRAME_SAMPLES = 2048  # a frame: 4 steps of SNAC's 512-sample hop
ORPHEUS_TEXT = "The port speaks in a voice of its own."
ORPHEUS_BATCH_TEXTS = CSM_BATCH_TEXTS
PROFILE_STEPS = 16  # decode steps a profile of the LM loops covers
DAC_SECONDS = 3.0


class OrpheusStubTokenizer:
    """``tokenizer(text).input_ids``: Llama-3-sized ids from characters."""

    def __call__(self, text: str):
        from types import SimpleNamespace

        return SimpleNamespace(input_ids=StubTokenizer().encode(text))


def build_orpheus(layers=None):
    """Orpheus-3B at the published widths (ModelConfig's defaults) with
    seeded random weights on the card, and SNAC-24kHz; int8 in groups of
    64, as mlx-community/orpheus-3b-0.1-ft-8bit is quantized.  ``layers``
    cuts the depth (phase 18)."""
    from mlx_audio_tpu_torch.models.tts.llama import Model, ModelConfig
    from mlx_audio_tpu_torch.models.tts.llama.llama import AUDIO_MARK, STOP_AUDIO
    from mlx_audio_tpu_torch.nn.quantize import quantize_model

    t0 = time.perf_counter()
    cfg = ModelConfig() if layers is None else ModelConfig(num_hidden_layers=layers)
    model = Model(cfg, tokenizer=OrpheusStubTokenizer(), device="cuda")
    # a trained Orpheus ends its audio with STOP_AUDIO; with random weights
    # the stop and the audio marker (which restarts the parsed codes) would
    # come at random, so their rows of the tied embedding are held at 0:
    # logit 0, below the top of 156 940 random ones
    with torch.no_grad():
        model.lm.model.embed_tokens.weight[[STOP_AUDIO, AUDIO_MARK]] = 0
    quantize_model(model.lm, group_size=64, bits=8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nbytes = sum(t.numel() * t.element_size() for t in model.lm.state_dict().values())
    print(f"Orpheus-3B built ({cfg.num_hidden_layers} layers) and quantized (int8, "
          f"groups of 64) in {time.perf_counter() - t0:.1f} s; LM state "
          f"{nbytes / 1e9:.3f} GB", flush=True)
    return model


def _check_orpheus(name, results, prompts):
    """One result a prompt, of its prompt and all ORPHEUS_TOKENS (the stop and
    the audio marker never come), parsed as 7-token frames: the random
    weights emit no audio marker, so the prompt's tokens parse as codes too,
    clipped to code 0."""
    if len(results) != len(prompts):
        fail(f"{name}: {len(results)} results for {len(prompts)} prompts")
    for r, p in zip(results, prompts):
        frames = r.token_count // 7
        if not (r.token_count == len(p) + ORPHEUS_TOKENS
                and r.samples == ORPHEUS_FRAME_SAMPLES * frames
                and np.isfinite(r.audio).all()):
            fail(f"{name}: {r.token_count} tokens, {r.samples} samples")


def _shared(a, b) -> int:
    """How many leading tokens two runs share."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def orpheus_runs(model, launches: dict) -> dict:
    """The entry points: greedy generate, generate_batch of 4, one sampled
    generate at the defaults (temperature 0.6, top-p 0.8, penalty 1.3);
    then a one-prompt generate_tokens_batch against generate_tokens, and each
    batch row against its one-row run."""
    from mlx_audio_tpu_torch.models.lm import causal
    from mlx_audio_tpu_torch.models.tts.llama import llama as orpheus
    from mlx_audio_tpu_torch.nn import kernels

    batch_tokens = []
    batch_fn = orpheus.generate_tokens_batch

    def recording_batch(*a, **k):
        out = batch_fn(*a, **k)
        batch_tokens.append([o.tolist() for o in out])
        return out

    path_calls = {}
    qmm = record_qmm_calls(path_calls)
    orpheus.generate_tokens_batch = recording_batch
    wall = {}
    run = path_runner(launches, wall)
    kw = dict(voice="tara", max_tokens=ORPHEUS_TOKENS)
    try:
        greedy = run("orpheus_generate", lambda: list(
            model.generate(ORPHEUS_TEXT, temperature=0.0, **kw)))
        batch = run("orpheus_generate_batch", lambda: model.generate_batch(
            ORPHEUS_BATCH_TEXTS, temperature=0.0, **kw))
        sampled = run("orpheus_generate_sampled", lambda: list(
            model.generate(ORPHEUS_TEXT, seed=3, **kw)))
    finally:
        kernels.quantized_matmul = qmm
        orpheus.generate_tokens_batch = batch_fn
    rows = model.prepare_input_ids([ORPHEUS_TEXT] + ORPHEUS_BATCH_TEXTS, "tara")
    _check_orpheus("orpheus generate", greedy, rows[:1])
    _check_orpheus("orpheus generate_batch", batch, rows[1:])
    _check_orpheus("orpheus generate (sampled)", sampled, rows[:1])
    for name in ("orpheus_generate", "orpheus_generate_batch", "orpheus_generate_sampled"):
        if launches[name]["quantized_matmul"] == 0:
            fail(f"{name}: quantized_matmul never launched")
    path_err = check_qmm_path(path_calls, qmm, "Orpheus")

    gkw = dict(max_tokens=ORPHEUS_TOKENS, temperature=0.0, repetition_penalty=1.3,
               stop_tokens=(orpheus.STOP_AUDIO,))
    single = [t for c in causal.generate_tokens(model.lm, rows[0], **gkw) for t in c]
    one_row = causal.generate_tokens_batch(model.lm, rows[:1], **gkw)[0].tolist()
    if one_row != single:
        fail(f"orpheus: a one-prompt generate_tokens_batch differs from "
             f"generate_tokens after {_shared(one_row, single)} of {len(single)} tokens")
    shared = []
    for prompt, row in zip(rows[1:], batch_tokens[0]):
        alone = [t for c in causal.generate_tokens(model.lm, prompt, **gkw) for t in c]
        shared.append(_shared(row, alone))
    print(f"orpheus: greedy, a one-prompt generate_tokens_batch equals "
          f"generate_tokens ({len(single)} tokens); the 4-row batch's rows share "
          f"{shared} of {ORPHEUS_TOKENS} tokens with their one-row runs; wall s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in wall.items()), flush=True)
    return {"wall": wall, "qmm_path_err": path_err, "batch_shared": shared,
            "qmm_path_shapes": len(path_calls)}


def profile_steps(label: str, run_steps, steps: int = PROFILE_STEPS,
                  table=CSM_KERNEL_GROUPS):
    """``run_steps()`` (``steps`` batch-1 decode steps, or one call with
    ``steps`` 1) under torch.profiler: prints the device's idle share
    between the first and the last kernel, device time by ``table`` group
    and the top kernels, and, for each of this repository's kernels with
    fewer events in the trace than its wrapper counted launches, both
    counts and the trace's events in order.  Returns
    {profile_idle_share, launches_per_step, device_ms_per_step, groups,
    device_ms}, or None when no device time was recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mlx_audio_tpu_torch.nn import kernels

    torch.cuda.synchronize()
    counted = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = {k: n - counted[k] for k, n in kernels.LAUNCHES.items()}
    busy, window, by_name = device_time(prof)
    if not by_name:
        print(f"{label} profile: the profiler recorded no device time (not measured)")
        return None
    groups = kernel_groups(by_name, table)
    device_ms = sum(ms for ms, _ in by_name.values())
    n = sum(n for _, n in by_name.values())
    what = f" of {steps} decode steps (batch 1)" if steps > 1 else ""
    print(f"{label} profile{what}: wall {1e3 * wall:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"of a {window / 1e3:.1f} ms kernel window (idle share {1 - busy / window:.4f}), "
          f"{n} kernels ({n / steps:.1f} a step); on {gpu_line()}")
    for group, (ms, k) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {group:28s} {ms:10.3f} ms  {ms / device_ms:7.2%}  {k:6d} launches")
    for name, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {ms:10.3f} ms {k:6d}x  {name[:90]}")
    for group in {g for _, g in table if g.endswith(" (this repo)")}:
        kernel = group.removesuffix(" (this repo)")
        traced = groups.get(group, (0.0, 0))[1]
        if traced >= counted[kernel]:  # a launch may run more than one kernel
            continue
        keys = [key for key, g in table if g == group]
        runs = []
        for e in sorted(prof.events(), key=lambda e: e.time_range.start):
            key = next((k for k in keys if k in e.name), None)
            if e.device_type != DeviceType.CUDA or key is None:
                continue
            variant = e.name[e.name.index(key):].split("(")[0]  # the template arguments
            if runs and runs[-1][0] == variant:
                runs[-1][1] += 1
            else:
                runs.append([variant, 1])
        print(f"  {kernel}: {counted[kernel]} launches counted, {traced} in the trace; "
              f"the trace in launch order: " + ", ".join(f"{v} x{k}" for v, k in runs))
    return {"profile_idle_share": 1 - busy / window, "launches_per_step": n / steps,
            "device_ms_per_step": busy / 1e3 / steps, "groups": groups,
            "device_ms": device_ms}


def lm_breakdown(label: str, lm, rows1, rows4, tokens: int, penalty: float,
                 context: int, synthesize, sample_rate: int) -> dict:
    """Batch-1 greedy synthesis through the causal loop's own steps, synced
    between them: prefill and first token, decode loop, the codec's decode
    (``synthesize(tokens) -> audio``); the decode loop at batch 4 (``rows4``);
    then a profile of PROFILE_STEPS batch-1 decode steps."""
    from mlx_audio_tpu_torch.models.lm import causal
    from mlx_audio_tpu_torch.nn import kernels

    torch.cuda.reset_peak_memory_stats()

    def state(rows):
        caches, pad_len, prompt, pen, window = causal._start(
            lm, rows, tokens, None, penalty, context)
        first = causal._prefill(lm, caches, pad_len, prompt).argmax(-1).to(torch.int32)
        window[:, -1] = first
        return caches, pad_len, pen, window, first

    def steps(st, n):
        caches, pad_len, pen, window, last = st
        return causal._decode_chunk(lm, caches, pad_len, last, window, n, 0.0, 0,
                                    1.0, pen, None)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = state(rows1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks, _, _ = steps(st, tokens - 1)
    toks = [int(st[-1][0])] + toks[:, 0].tolist()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    audio = synthesize(toks)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    st4 = state(rows4)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    steps(st4, tokens - 1)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    audio_s = audio.shape[-1] / sample_rate
    out = {"prefill_s": t1 - t0, "decode_s": t2 - t1, "codec_decode_s": t3 - t2,
           "tokens": tokens, "tokens_per_s": (tokens - 1) / (t2 - t1),
           "tokens_per_s_batch4": 4 * (tokens - 1) / (t5 - t4),
           "audio_s": audio_s, "real_time_factor": (t3 - t0) / audio_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{label} breakdown (int8, greedy, penalty {penalty}): " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in out.items())
        + f"; on {gpu_line()}", flush=True)

    st = state(rows1)
    steps(st, 2)  # warm
    kernels.reset_launches()
    prof = profile_steps(label, lambda: steps(st, PROFILE_STEPS))
    if prof is None:
        return out
    groups, device_ms = prof.pop("groups"), prof.pop("device_ms")
    qmm_ms = groups.get("quantized_matmul (this repo)", (0.0, 0))[0]
    out.update(prof, profile_qmm_share=qmm_ms / device_ms)
    print(f"{label} profile: quantized_matmul {kernels.LAUNCHES['quantized_matmul']} "
          f"calls, {qmm_ms:.3f} ms, {out['profile_qmm_share']:.2%} of device time",
          flush=True)
    return out


def orpheus_breakdown(model) -> dict:
    from mlx_audio_tpu_torch.models.tts.llama import decode_audio_from_codes

    def synthesize(toks):
        code_list = model.parse_output(np.asarray(toks)[None])[0]
        return decode_audio_from_codes(code_list, model._snac)

    return lm_breakdown("orpheus", model.lm, model.prepare_input_ids([ORPHEUS_TEXT], "tara"),
                        model.prepare_input_ids(ORPHEUS_BATCH_TEXTS, "tara"),
                        ORPHEUS_TOKENS, 1.3, 20, synthesize, model.sample_rate)


def dac_runs(launches: dict) -> dict:
    """DAC-44kHz (the published config) with seeded random weights: encode
    and decode 3 s of seeded audio, compress and decompress 3 s, print the
    route each conv took; then the same 3 s through the same weights on the
    CPU (the kernels' plain versions and the library's convs): the codes
    must be equal, the encoder's latents and the audio within TOL."""
    from mlx_audio_tpu_torch.codec.dac import DAC, dac_44khz_config
    from mlx_audio_tpu_torch.nn import layers

    config = dac_44khz_config()
    dac = DAC(config, device="cuda", seed=0)
    sr = dac.sample_rate
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(int(DAC_SECONDS * sr)) * 0.1).astype(np.float32)
    x = torch.as_tensor(audio)[None, None]
    routes = {}

    def encode_decode():
        z, codes, latents = dac.encode(x.cuda())
        return codes, latents, dac.decode(z)

    def compress():
        f = dac.compress(audio)
        return f, dac.decompress(f)

    wall = {}
    run = path_runner(launches, wall)
    route_fn = route_recorder(routes)
    try:
        codes, latents, y = run("dac_encode_decode", encode_decode)
    finally:
        layers.conv1d_route = route_fn
    f, wav = run("dac_compress", compress)
    frames = -(-audio.shape[0] // dac.hop_length)
    if (codes.shape != (1, config.n_codebooks, frames)
            or y.shape != (1, 1, frames * dac.hop_length)):
        fail(f"dac: codes {tuple(codes.shape)}, audio {tuple(y.shape)}")
    if not (bool(torch.isfinite(y).all()) and np.isfinite(wav).all()
            and wav.shape == (1, audio.shape[0]) and f.codes.shape[1] == config.n_codebooks):
        fail(f"dac: compress codes {f.codes.shape}, decompress {wav.shape}, or not finite")
    for need in ("banded_conv1d", "dilated_conv1d"):
        if launches["dac_encode_decode"][need] == 0:
            fail(f"dac_encode_decode: {need} never launched")
    print_routes("dac", routes)

    # the same weights and clip on the CPU
    t0 = time.perf_counter()
    ref = cpu_twin(lambda: DAC(config, device="cpu"), dac)
    z_ref, codes_ref, latents_ref = ref.encode(x)
    y_ref = ref.decode(z_ref)
    cpu_s = time.perf_counter() - t0
    codes, latents, y = codes.cpu(), latents.cpu(), y.cpu()
    differ = int((codes != codes_ref).sum())
    latent_err = float((latents - latents_ref).abs().max())
    y_err = float((y - y_ref).abs().max())
    print(f"dac ({DAC_SECONDS} s at {sr} Hz): codes {tuple(codes.shape)}, audio "
          f"{tuple(y.shape)}; compress: {f.codes.shape[-1] // f.chunk_length} windows of "
          f"{f.chunk_length} frames, decompress {wav.shape}; wall s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in wall.items())
          + f"; against the CPU ({cpu_s:.1f} s) on the same {DAC_SECONDS} s: codes "
          f"differing {differ} of {codes.numel()}, encoder latents max abs diff "
          f"{latent_err:.3e} (max |latent| {float(latents_ref.abs().max()):.3f}), "
          f"audio {y_err:.3e} (max |audio| {float(y_ref.abs().max()):.4f}); "
          f"atol {TOL['atol']}, rtol {TOL['rtol']}", flush=True)
    if differ:
        fail(f"dac: {differ} of {codes.numel()} codes on the card differ from the CPU's")
    if not torch.allclose(latents, latents_ref, **TOL):
        fail(f"dac: the encoder's latents on the card differ from the CPU's by {latent_err:.3e}")
    if not torch.allclose(y, y_ref, **TOL):
        fail(f"dac: decode on the card differs from the CPU's by {y_err:.3e}")
    return {"wall": wall, "audio_err": y_err, "latent_err": latent_err}


# ---------------------------------------------------------------------------
# phase 7: OuteTTS-1B int8 and Dia-1.6B
# ---------------------------------------------------------------------------

OUTETTS_TOKENS = 240  # 120 frames of a c1 and a c2 code; the DAC decodes 112 of them:
# 4 479 rows at C = 384, past the banded route's 4 096
OUTETTS_TEXT = ORPHEUS_TEXT
OUTETTS_BATCH_TEXTS = CSM_BATCH_TEXTS
OUTETTS_STREAM_INTERVAL = 1.0  # a decode every 137 tokens
OUTETTS_TIMED_TOKENS = 64  # tokens a timed decode of the breakdown
# the stub tokenizer's ids: <|c1_n|> at OUTETTS_CODES + 2 n, <|c2_n|> at
# OUTETTS_CODES + 2 n + 1, <|im_end|> at OUTETTS_EOS
OUTETTS_CODES, OUTETTS_EOS = 130_000, 133_000
OUTETTS_OWN = 0.02  # each code row's own part, against the shared part's RMS

DIA_STEPS = 100  # decode steps: 70 frames, 0.81 s at 86.13 a second, after the 30-frame
# drop: 4 480 rows at C = 384 in the DAC decode, past the banded route's 4 096
DIA_TEXT = "[S1] The port speaks in a voice of its own. [S2] And it answers."
DIA_BATCH_TEXTS = ["[S1] One short line. [S2] Yes.",
                   "[S1] A second line, a little longer. [S2] It is.",
                   "[S1] Three. [S2] Four.",
                   "[S1] And the fourth line closes the batch. [S2] Done."]
DIA_BUCKET_STEPS = 40  # steps of the encoder-bucket comparison: its DAC decode drops
# 30 frames
DIA_TIMED_STEPS = 32  # steps a timed decode of the breakdown
DIA_TF_STEPS = 2  # teacher-forced steps held against the CPU, to TOL
DIA_CFG_SCALE = 3.0  # the entry points' default classifier-free guidance


class OuteTTSStubTokenizer:
    """``encode(text)``: the <|c1_n|> and <|c2_n|> codes (n < 1025,
    interleaved) and <|im_end|> at ids of their own below the vocabulary of
    134 400, every other character at an id of StubTokenizer's."""

    def encode(self, text: str, add_special_tokens: bool = False) -> list:
        import re

        def chars(part):
            return [1_000 + (ord(c) * 7_919) % 120_000 for c in part]

        ids, pos = [], 0
        for m in re.finditer(r"<\|(c[12])_(\d+)\|>|<\|im_end\|>", text):
            ids += chars(text[pos:m.start()])
            if m.group(1) is None:
                ids.append(OUTETTS_EOS)
            else:
                ids.append(OUTETTS_CODES + 2 * int(m.group(2)) + (m.group(1) == "c2"))
            pos = m.end()
        return ids + chars(text[pos:])


def build_outetts():
    """OuteTTS-1B at the published widths (ModelConfig's defaults) with
    seeded random weights on the card, int8 in groups of 64, and the 24 kHz
    speech DAC (seeded random weights)."""
    from mlx_audio_tpu_torch.models.lm import causal
    from mlx_audio_tpu_torch.models.tts.outetts import Model, ModelConfig
    from mlx_audio_tpu_torch.nn.quantize import quantize_model

    t0 = time.perf_counter()
    model = Model(ModelConfig(), tokenizer=OuteTTSStubTokenizer(), device="cuda")
    # A trained OuteTTS speaks in c1, c2 code pairs and ends with
    # <|im_end|>.  Of the random weights' 134 400 tokens 2 050 are codes, so
    # every other row of the tied embedding is scaled by 1e-2 (on the input
    # side the first RMSNorm normalizes the scale away; the head's logits of
    # those tokens shrink a hundredfold) and the <|im_end|> row is held at 0.
    # With random code rows greedy decoding then repeats one code (the tied
    # head favours the token just fed back) and one stream decodes to no
    # audio, so every code row is a shared vector, the sum of the prompts'
    # last hidden states, plus a random part of its own at OUTETTS_OWN of
    # the shared part's RMS (the sum at U(-1, 1)'s RMS): the code logits are
    # positive from the first step, far above the non-code ones, and close
    # enough to each other that the repetition penalty (a tenth of a code's
    # logit) keeps greedy decoding from repeating a code within its window;
    # which code comes next, c1 or c2, is set by the rows' own parts against
    # the hidden state the LM computed.  Code 1024 of either stream is past
    # the DAC's 1024 bins; its rows are held at 0 (logit 0, below the
    # positive ones), as a trained model does not emit it.
    with torch.no_grad():
        w = model.lm.model.embed_tokens.weight
        codes = torch.zeros(w.shape[0], dtype=torch.bool, device=w.device)
        codes[OUTETTS_CODES:OUTETTS_CODES + 2 * 1025] = True
        w[~codes] *= 1e-2
        w[OUTETTS_EOS] = 0
        rows = _outetts_rows(model, [OUTETTS_TEXT] + OUTETTS_BATCH_TEXTS)
        caches, pad_len, prompt, _, _ = causal._start(model.lm, rows, 1, None, 1.0, 1)
        last = model.lm.model.prefill(caches, prompt, pad_len)[0][:, -1]
        row = last.sum(0)
        own = torch.randn(int(codes.sum()), w.shape[1], device=w.device,
                          generator=torch.Generator(device=w.device).manual_seed(1))
        w[codes] = (row / row.pow(2).mean().sqrt() + OUTETTS_OWN * own) * 3 ** -0.5
        w[OUTETTS_CODES + 2 * 1024:OUTETTS_CODES + 2 * 1025] = 0
        if not bool((last @ w[OUTETTS_CODES] > 0).all()):
            fail("outetts: a prompt's first code logit is not positive")
    quantize_model(model.lm, group_size=64, bits=8)
    dac = model.audio_processor.audio_codec.model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nbytes = sum(t.numel() * t.element_size() for t in model.lm.state_dict().values())
    print(f"OuteTTS-1B built and quantized (int8, groups of 64) in "
          f"{time.perf_counter() - t0:.1f} s; LM state {nbytes / 1e9:.3f} GB; "
          f"DAC-24kHz hop {dac.hop_length}, {dac.n_codebooks} codebooks", flush=True)
    return model


def _outetts_rows(model, texts):
    """The prompt rows the entry points build: each chunk of each text
    (``chunk_text``) in the completion grammar."""
    from mlx_audio_tpu_torch.models.tts.outetts import PromptProcessor

    pp = PromptProcessor(model._tokenizer)
    return [np.asarray(model._tokenizer.encode(pp.get_completion_prompt(c)))
            for t in texts for c in model.chunk_text(t)]


def _check_outetts(name, results, n):
    if len(results) != n:
        fail(f"{name}: {len(results)} results for {n} texts")
    for r in results:
        if not (r.samples > 0 and np.isfinite(r.audio).all()):
            fail(f"{name}: {r.samples} samples, or not finite")


def outetts_runs(model, launches: dict) -> dict:
    """The entry points: greedy generate of OUTETTS_TOKENS, the same
    streamed, generate_batch of 4, one sampled generate at the defaults
    (temperature 0.4, top-p 0.9, penalty 1.1); then a one-text
    generate_batch against the greedy generate: tokens equal, audio within
    TOL."""
    from mlx_audio_tpu_torch.models.tts.outetts import PromptProcessor
    from mlx_audio_tpu_torch.models.tts.outetts import outetts as outetts_mod
    from mlx_audio_tpu_torch.nn import kernels

    tokens, batch_tokens = [], []
    gen_fn, batch_fn = outetts_mod.generate_tokens, outetts_mod.generate_tokens_batch

    def recording_gen(*a, **k):
        toks = []
        tokens.append(toks)
        for chunk in gen_fn(*a, **k):
            toks.extend(int(t) for t in chunk)
            yield chunk

    def recording_batch(*a, **k):
        outs = batch_fn(*a, **k)
        batch_tokens.append([o.tolist() for o in outs])
        return outs

    path_calls, conv_calls = {}, {}
    qmm = record_qmm_calls(path_calls)
    convs = record_conv_calls(conv_calls)
    outetts_mod.generate_tokens = recording_gen
    outetts_mod.generate_tokens_batch = recording_batch
    wall = {}
    run = path_runner(launches, wall)
    kw = dict(max_tokens=OUTETTS_TOKENS)
    try:
        greedy = run("outetts_generate", lambda: list(
            model.generate(OUTETTS_TEXT, temperature=0.0, **kw)))
        stream = run("outetts_generate_stream", lambda: list(model.generate(
            OUTETTS_TEXT, temperature=0.0, stream=True,
            streaming_interval=OUTETTS_STREAM_INTERVAL, **kw)))
        batch = run("outetts_generate_batch", lambda: model.generate_batch(
            OUTETTS_BATCH_TEXTS, temperature=0.0, **kw))
        sampled = run("outetts_generate_sampled", lambda: list(
            model.generate(OUTETTS_TEXT, seed=3, **kw)))
        one = model.generate_batch([OUTETTS_TEXT], temperature=0.0, **kw)
    finally:
        kernels.quantized_matmul = qmm
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
        outetts_mod.generate_tokens = gen_fn
        outetts_mod.generate_tokens_batch = batch_fn
    _check_outetts("outetts generate", greedy, 1)
    _check_outetts("outetts generate_batch", batch, len(OUTETTS_BATCH_TEXTS))
    _check_outetts("outetts generate (sampled)", sampled, 1)
    if len(tokens[0]) != OUTETTS_TOKENS:
        fail(f"outetts: greedy generate stopped after {len(tokens[0])} tokens")
    frames = len(PromptProcessor(model._tokenizer).extract_audio_from_tokens(tokens[0])[0])
    codes = [t for t in tokens[0] if OUTETTS_CODES <= t < OUTETTS_CODES + 2 * 1025]
    if codes == sorted(codes):
        fail("outetts: the greedy codes come in id order, as tied code logits give "
             "them: the tokens do not depend on the LM")
    hop = model.audio_processor.audio_codec.model.hop_length
    if abs(greedy[0].samples - hop * frames) >= hop:
        fail(f"outetts: {greedy[0].samples} samples for {frames} frames")
    # the streamed run: the same tokens, decoded at chunk boundaries
    whole = greedy[0].audio
    if (tokens[1] != tokens[0] or len(stream) < 2
            or sum(r.samples for r in stream) != whole.shape[0]):
        fail(f"outetts stream: {len(stream)} chunks of "
             f"{[r.samples for r in stream]} samples against {whole.shape[0]}")
    last = torch.as_tensor(stream[-1].audio)
    tail = torch.as_tensor(whole[whole.shape[0] - last.shape[0]:])
    if not torch.allclose(last, tail, **TOL):
        fail(f"outetts stream: the last chunk differs from the whole run's tail by "
             f"{float((last - tail).abs().max()):.3e}")
    for name in ("outetts_generate", "outetts_generate_stream", "outetts_generate_batch",
                 "outetts_generate_sampled"):
        missing = [k for k in ("quantized_matmul", "banded_conv1d", "dilated_conv1d")
                   if launches[name][k] == 0]
        if missing:
            fail(f"{name}: kernels never launched: {missing}")
    path_err = check_qmm_path(path_calls, qmm, "OuteTTS")
    conv_err = check_conv_path(conv_calls, convs, "OuteTTS")

    one_row = batch_tokens[-1][0]
    if one_row != tokens[0]:
        fail(f"outetts: a one-text generate_batch differs from generate "
             f"after {_shared(one_row, tokens[0])} of {len(tokens[0])} tokens")
    if not (one[0].audio.shape == whole.shape
            and np.allclose(one[0].audio, whole, **TOL)):
        fail("outetts: a one-text generate_batch's audio differs from generate's")
    audio_s = whole.shape[0] / model.sample_rate
    print(f"outetts: greedy, {frames} frames from {len(tokens[0])} tokens "
          f"({len(set(codes))} distinct codes of {len(codes)}), "
          f"{audio_s:.3f} s of audio, real-time factor "
          f"{wall['outetts_generate'] / audio_s:.4f}; streamed in {len(stream)} chunks "
          f"of {[r.samples for r in stream]} samples, the same tokens, the last chunk "
          f"equal to the whole run's tail; a one-text generate_batch equals "
          f"generate, tokens and audio; wall s: " + ", ".join(f"{k} {v:.3f}" for k, v in wall.items()),
          flush=True)
    return {"wall": wall, "qmm_path_err": path_err, "qmm_path_shapes": len(path_calls),
            "conv_path_err": conv_err, "conv_path_shapes": _per_kernel(conv_calls),
            "frames": frames}


def outetts_breakdown(model) -> dict:
    from mlx_audio_tpu_torch.models.tts.outetts import PromptProcessor

    pp = PromptProcessor(model._tokenizer)
    return lm_breakdown("outetts", model.lm, _outetts_rows(model, [OUTETTS_TEXT]),
                        _outetts_rows(model, OUTETTS_BATCH_TEXTS), OUTETTS_TIMED_TOKENS,
                        1.1, 64, lambda t: model._decode(pp.extract_audio_from_tokens(t)),
                        model.sample_rate)


def build_dia():
    """Dia-1.6B at the published widths (DiaConfig's defaults) with seeded
    random weights on the card, and DAC-44kHz (seeded random weights)."""
    from mlx_audio_tpu_torch.codec.dac import DAC, dac_44khz_config
    from mlx_audio_tpu_torch.models.tts.dia import DiaConfig, Model

    t0 = time.perf_counter()
    model = Model(DiaConfig(), dac_model=DAC(dac_44khz_config(), device="cuda", seed=0),
                  device="cuda")
    # a trained Dia ends a text with EOS (1024) on channel 0; random weights
    # would emit it at random, so channel 0's EOS column of the logits head
    # is held at 0: its CFG logit is exactly 0, below the top of 1 024
    # random ones, and the top-k of 35 masks it
    with torch.no_grad():
        model.model.decoder.logits_dense.weight[:, 0, 1024] = 0
    torch.cuda.synchronize()
    state = model.model.state_dict()
    n = sum(t.numel() for t in state.values())
    dec = sum(t.numel() * t.element_size() for k, t in state.items()
              if k.startswith("decoder.layers.") or k.startswith("decoder.logits"))
    print(f"Dia-1.6B built in {time.perf_counter() - t0:.1f} s: {n / 1e9:.3f} B "
          f"parameters, {4 * n / 1e9:.3f} GB float32, {dec / 1e9:.3f} GB read a "
          "decode step (decoder layers and logits head)", flush=True)
    return model


def dia_runs(model, launches: dict) -> dict:
    """The entry points: greedy generate of DIA_STEPS, generate_batch of 4
    texts, a one-text generate_batch (its codes must equal the single run's),
    generate_batch of two texts with the encoder bucketed and at all 1024
    positions (codes equal), one sampled generate at the defaults
    (temperature 1.3, top-k 35, CFG 3)."""
    from mlx_audio_tpu_torch.models.tts.dia import model as dia_mod
    from mlx_audio_tpu_torch.models.tts.dia.audio import TAIL_DROP
    from mlx_audio_tpu_torch.nn import kernels

    seen = {"single": [], "batch": []}
    single_fn, batch_fn = dia_mod.codebook_to_audio, dia_mod.codebook_to_audio_batch
    dia_mod.codebook_to_audio = lambda codes, *a, **k: (
        seen["single"].append(codes), single_fn(codes, *a, **k))[1]
    dia_mod.codebook_to_audio_batch = lambda codes, *a, **k: (
        seen["batch"].append(codes), batch_fn(codes, *a, **k))[1]
    conv_calls = {}
    convs = record_conv_calls(conv_calls)
    wall = {}
    run = path_runner(launches, wall)
    greedy = dict(temperature=0.0, max_tokens=DIA_STEPS)
    two = DIA_BATCH_TEXTS[:2]
    try:
        single = run("dia_generate", lambda: list(model.generate(DIA_TEXT, **greedy)))
        batch = run("dia_generate_batch", lambda: model.generate_batch(DIA_BATCH_TEXTS,
                                                                       **greedy))
        one = model.generate_batch([DIA_TEXT], **greedy)
        model.generate_batch(two, temperature=0.0, max_tokens=DIA_BUCKET_STEPS)
        model.generate_batch(two, temperature=0.0, max_tokens=DIA_BUCKET_STEPS,
                             _encoder_bucket=model.config.data.text_length)
        sampled = run("dia_generate_sampled", lambda: list(
            model.generate(DIA_TEXT, max_tokens=DIA_STEPS, seed=3)))
    finally:
        dia_mod.codebook_to_audio, dia_mod.codebook_to_audio_batch = single_fn, batch_fn
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
    samples = (DIA_STEPS - TAIL_DROP) * model._get_dac().hop_length
    for name, results, n in (("dia generate", single, 1),
                             ("dia generate_batch", batch, len(DIA_BATCH_TEXTS)),
                             ("dia one-text generate_batch", one, 1),
                             ("dia generate (sampled)", sampled, 1)):
        if len(results) != n:
            fail(f"{name}: {len(results)} results for {n} texts")
        for r in results:
            if not (r.samples == samples and np.isfinite(r.audio).all()):
                fail(f"{name}: {r.samples} samples (expected {samples}), or not finite")
    codes = seen["single"][0]
    if codes.shape != (model.config.data.channels, 1 + DIA_STEPS):
        fail(f"dia: greedy codes {codes.shape}")
    if not np.array_equal(seen["batch"][1][0], codes):
        n = int((seen["batch"][1][0] != codes).any(0).sum())
        fail(f"dia: a one-text generate_batch differs from generate in {n} frames")
    bucketed, full = seen["batch"][2], seen["batch"][3]
    if not all(np.array_equal(a, b) for a, b in zip(bucketed, full)):
        fail("dia: the encoder bucket changes the codes against all 1024 positions")
    for name in ("dia_generate", "dia_generate_batch", "dia_generate_sampled"):
        missing = [k for k in ("banded_conv1d", "dilated_conv1d") if launches[name][k] == 0]
        if missing:
            fail(f"{name}: kernels never launched in its DAC decode: {missing}")
    conv_err = check_conv_path(conv_calls, convs, "Dia")
    audio_s = samples / model.sample_rate
    print(f"dia: greedy {DIA_STEPS} steps, codes {codes.shape}, {audio_s:.3f} s of "
          f"audio, real-time factor {wall['dia_generate'] / audio_s:.4f} (generate's "
          f"wall time over the audio's length); a one-text "
          f"generate_batch equals generate; the encoder bucket's codes equal all "
          f"1024 positions' ({DIA_BUCKET_STEPS} steps, 2 texts); wall s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in wall.items()), flush=True)
    return {"wall": wall, "codes": codes, "real_time_factor": wall["dia_generate"] / audio_s,
            "conv_path_err": conv_err, "conv_path_shapes": _per_kernel(conv_calls)}


def _dia_decode(model, st, step0: int, n: int):
    """n greedy decode steps (CFG 3, top-k 35) from the decode state ``st``
    (``Model._start``'s) at position ``step0``; returns the new state."""
    from mlx_audio_tpu_torch.models.tts.dia.model import _dia_chunk

    data = model.config.data
    delay = torch.as_tensor(data.delay_pattern, device=model.device)
    caches, kv, ca, last = st
    _, last = _dia_chunk(model.model, caches, kv, ca, last, step0, 0, delay, None,
                         data.audio_bos_value, chunk=n, temperature=0.0, top_k=35,
                         cfg_scale=DIA_CFG_SCALE, force_bos=True)
    return caches, kv, ca, last


def dia_breakdown(model, codes) -> dict:
    """Batch-1 greedy synthesis in its stages, synced between them: text
    encoder (1024 positions, 2 rows) with the cross keys, DIA_TIMED_STEPS
    decode steps, the DAC decode of the greedy run's codes; the decode at
    batch 4 (8 rows); then a profile of PROFILE_STEPS batch-1 steps."""
    from mlx_audio_tpu_torch.models.tts.dia.audio import codebook_to_audio

    data = model.config.data

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = model._start([DIA_TEXT], DIA_STEPS + 64)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _dia_decode(model, st, 0, DIA_TIMED_STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    audio = codebook_to_audio(codes, model._get_dac(), data.delay_pattern, c=data.channels)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    st4 = model._start(DIA_BATCH_TEXTS, DIA_STEPS + 64)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    _dia_decode(model, st4, 0, DIA_TIMED_STEPS)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    del st4
    steps_per_s = DIA_TIMED_STEPS / (t2 - t1)
    audio_s = audio.shape[-1] / model.sample_rate
    out = {"encoder_s": t1 - t0, "steps_per_s": steps_per_s,
           "steps_per_s_batch4": DIA_TIMED_STEPS / (t5 - t4), "dac_decode_s": t3 - t2,
           "audio_s": audio_s,
           "real_time_factor_from_rate": (t1 - t0 + DIA_STEPS / steps_per_s + t3 - t2)
           / audio_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}

    print("dia breakdown (f32, greedy, CFG 3, batch 1 = 2 rows; real_time_factor_from_rate "
          f"is computed, {DIA_STEPS} steps at the timed rate): " + ", ".join(
              f"{k} {v:.4f}" for k, v in out.items()) + f"; on {gpu_line()}", flush=True)
    st = _dia_decode(model, model._start([DIA_TEXT], DIA_STEPS + 64), 0, 2)  # warm
    prof = profile_steps("dia", lambda: _dia_decode(model, st, 2, PROFILE_STEPS))
    if prof is not None:
        del prof["groups"], prof["device_ms"]
        out.update(prof)
    return out


def _dia_tf_logits(model, dm, codes, steps: int) -> torch.Tensor:
    """Float decoder logits [steps, 2, C, V] (on the CPU) of ``codes``'
    first ``steps`` frames fed back, teacher-forced, through ``dm`` (the
    model's DiaModel or a copy of it) from the entry points' own start
    state (``Model._start``: caches in ``dm``'s dtype)."""
    dev = dm.decoder.norm.weight.device
    caches, kv, ca, _ = model._start([DIA_TEXT], steps, model=dm)
    out = []
    with torch.no_grad():
        for t in range(steps):
            frame = torch.as_tensor(codes[:, t], dtype=torch.long, device=dev)
            step, _ = dm.decoder.step(frame[None, None].expand(2, 1, -1),
                                      torch.full((1, 1), t, device=dev), caches, kv, None, ca)
            out.append(step[:, 0].float().cpu())
    return torch.stack(out)


def dia_card_against_cpu(model, codes) -> float:
    """The greedy run's codes fed back, teacher-forced, for DIA_TF_STEPS
    steps through the card's weights and through the same weights on the
    CPU (text encoder included): the logits must agree within TOL.
    Returns the largest difference."""
    from mlx_audio_tpu_torch.models.tts.dia import DiaModel

    t0 = time.perf_counter()
    card = _dia_tf_logits(model, model.model, codes, DIA_TF_STEPS)
    cpu_model = DiaModel(model.config)
    # assigned, not copied: DiaModel leaves its weights empty, and writing
    # 6.4 GB of fresh pages costs seconds
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.model.state_dict().items()},
                              assign=True)
    cpu = _dia_tf_logits(model, cpu_model, codes, DIA_TF_STEPS)
    err = float((card - cpu).abs().max())
    print(f"dia card against the CPU: {DIA_TF_STEPS} teacher-forced steps of the greedy "
          f"codes, logits {tuple(card.shape)} max abs diff {err:.3e} (max |logit| "
          f"{float(cpu.abs().max()):.3f}; atol {TOL['atol']}, rtol "
          f"{TOL['rtol']}) in {time.perf_counter() - t0:.1f} s", flush=True)
    if not torch.allclose(card, cpu, **TOL):
        fail(f"dia: teacher-forced logits on the card differ from the CPU's by {err:.3e}")
    return err


# ---------------------------------------------------------------------------
# phase 8: EnCodec-24kHz, Bark and Vocos-mel-24kHz
# ---------------------------------------------------------------------------

ENCODEC_SECONDS = 3.0
ENCODEC_BANDWIDTH = 6.0  # kbps: 8 codebooks, as Bark decodes
BARK_SEMANTIC_STEPS = 76  # 1.52 s of audio: 228 coarse steps, 114 frames
BARK_GREEDY = 1e-6  # a temperature at which every stage takes the argmax
BARK_TEXT = "The port speaks in a voice of its own."
BARK_BATCH_TEXTS = CSM_BATCH_TEXTS
BARK_TIMED_STEPS = 64  # semantic and coarse steps a timed decode of the breakdown
BARK_TF_STEPS = 8  # teacher-forced steps held against the CPU, to TOL
BARK_STOP_LOGIT = 10.0  # the early stop's logit is about minus this
VOCOS_SECONDS = 3.0


class BarkStubTokenizer:
    """Stands in for bert-base-multilingual-cased: one id a word, drawn from
    the word's bytes, below 119 552 (the text embedding's 129 600 rows from
    offset 10 048)."""

    def encode(self, text: str, add_special_tokens: bool = False) -> list:
        return [1000 + sum(w.encode()) * 7919 % 110_000 for w in text.split()]


def run_counted(run, name: str, fn, lstm_routes: dict):
    """path_runner's run, with kernels.lstm's launches by route read just
    after into lstm_routes[name]."""
    from mlx_audio_tpu_torch.nn import kernels

    out = run(name, fn)
    lstm_routes[name] = dict(kernels.LSTM_ROUTE_LAUNCHES)
    return out


def _check_row_route(name: str, routes: dict, want=None) -> None:
    if routes["cluster"] or not routes["row"] or (want is not None and routes["row"] != want):
        fail(f"{name}: lstm launches by route {routes}"
             + (f" (expected {want} on the row route)" if want is not None else ""))


ENCODEC_AUDIO_STD = 0.1  # the decoded audio's scale, set by the last conv


def build_encodec():
    """EnCodec-24kHz (``facebook/encodec_24khz``'s config) with seeded random
    weights on the card, arranged on a seeded 1 s clip: each codebook is
    redrawn at the scale of the encoder's output (a trained codebook sits
    where the encoder's outputs are; at its init scale every frame would
    pick one of a few codes), and the decoder's last conv is scaled so the
    clip decodes at a standard deviation of ENCODEC_AUDIO_STD (at the init
    scale the audio is about 1e-5, where an atol of 1e-4 would hold
    nothing)."""
    from mlx_audio_tpu_torch.codec.encodec import Encodec, encodec_24khz_config

    codec = Encodec(encodec_24khz_config(), device="cuda", seed=0)
    sr = codec.config.sampling_rate
    clip = torch.as_tensor(np.random.default_rng(5).standard_normal(sr) * 0.1,
                           dtype=torch.float32)[None, :, None]
    with torch.no_grad():
        scale = float(codec.encoder(clip.cuda()).std())
        gen = torch.Generator(device="cuda").manual_seed(1)
        for layer in codec.quantizer.layers:
            layer.codebook.embed.copy_(torch.randn(
                layer.codebook.embed.shape, generator=gen, device="cuda") * scale)
        codes, scales = codec.encode(clip, bandwidth=ENCODEC_BANDWIDTH)
        gain = ENCODEC_AUDIO_STD / float(codec.decode(codes, scales).std())
        last = codec.decoder.layers[-1]
        last.weight.mul_(gain)
        last.bias.mul_(gain)
    return codec


def _code_flip_report(ref, codes_card, codes_cpu, x_cpu) -> str:
    """At the first (codebook, frame) where the card's code differs from the
    CPU's: the CPU's squared distances from its residual to both codes."""
    diff = (codes_card != codes_cpu).nonzero()
    _, level, frame = (int(v) for v in diff[0])
    with torch.no_grad():
        residual = ref.encoder(x_cpu)[0, frame]
        for i in range(level):
            residual = residual - ref.quantizer.layers[i].decode(codes_cpu[0, i, frame])
        emb = ref.quantizer.layers[level].codebook.embed
        a, b = int(codes_card[0, level, frame]), int(codes_cpu[0, level, frame])
        da, db = (float(((residual - emb[c]) ** 2).sum()) for c in (a, b))
    return (f"first at codebook {level} frame {frame}: card code {a} (CPU distance "
            f"{da:.6e}), CPU code {b} (distance {db:.6e})")


def encodec_runs(codec, launches: dict, lstm_routes: dict) -> dict:
    """EnCodec-24kHz on ENCODEC_SECONDS of seeded audio at 6 kbps: encode and
    decode, each timed, the route of every conv printed, and lstm's launches
    by route (4 on the row route: two encoder and two decoder layers at H =
    512); then the same clip through the same weights on the CPU: codes
    equal, audio within TOL; lstm held to its plain version on the path's
    operands."""
    from mlx_audio_tpu_torch.codec.encodec import Encodec, preprocess_audio
    from mlx_audio_tpu_torch.nn import kernels, layers

    sr = codec.config.sampling_rate
    audio = (np.random.default_rng(0).standard_normal(int(ENCODEC_SECONDS * sr))
             * 0.1).astype(np.float32)
    x, mask = preprocess_audio(audio, sr)
    routes, path_calls, wall = {}, {}, {}
    run = path_runner(launches, wall)

    def encode_decode():
        t0 = time.perf_counter()
        codes, scales = codec.encode(x, mask, bandwidth=ENCODEC_BANDWIDTH)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y = codec.decode(codes, scales, mask)
        torch.cuda.synchronize()
        wall["encodec_encode"], wall["encodec_decode"] = t1 - t0, time.perf_counter() - t1
        return codes, y

    route_fn = route_recorder(routes)
    lstm = record_lstm_calls(path_calls)
    try:
        codes, y = run_counted(run, "encodec_encode_decode", encode_decode, lstm_routes)
    finally:
        layers.conv1d_route, kernels.lstm = route_fn, lstm
    frames = audio.shape[0] // 320
    if codes.shape != (1, 1, 8, frames) or y.shape != (1, audio.shape[0], 1):
        fail(f"encodec: codes {tuple(codes.shape)}, audio {tuple(y.shape)}")
    if not bool(torch.isfinite(y).all()):
        fail("encodec: audio not finite")
    _check_row_route("encodec_encode_decode", lstm_routes["encodec_encode_decode"], 4)
    print_routes("encodec", routes)
    path_err = check_lstm_path(path_calls, lstm, "EnCodec")

    t0 = time.perf_counter()
    ref = cpu_twin(lambda: Encodec(codec.config, device="cpu"), codec)
    codes_ref, scales_ref = ref.encode(x, mask, bandwidth=ENCODEC_BANDWIDTH)
    y_ref = ref.decode(codes_ref, scales_ref, mask)
    cpu_s = time.perf_counter() - t0
    codes, y = codes.cpu(), y.cpu()
    differ = int((codes != codes_ref).sum())
    y_err = float((y - y_ref).abs().max())
    print(f"encodec ({ENCODEC_SECONDS} s at {sr} Hz, {ENCODEC_BANDWIDTH} kbps): codes "
          f"{tuple(codes.shape)} ({len(torch.unique(codes))} distinct), audio "
          f"{tuple(y.shape)}; wall s: " + ", ".join(f"{k} {v:.4f}" for k, v in wall.items())
          + f"; lstm by route {json.dumps(lstm_routes['encodec_encode_decode'])}; against "
          f"the CPU ({cpu_s:.1f} s) on the same clip: codes differing {differ} of "
          f"{codes.numel()}, audio {y_err:.3e} (max |audio| {float(y_ref.abs().max()):.4f});"
          f" atol {TOL['atol']}, rtol {TOL['rtol']}", flush=True)
    if differ:
        fail(f"encodec: {differ} of {codes.numel()} codes on the card differ from the "
             f"CPU's; " + _code_flip_report(ref, codes[0], codes_ref[0], x))
    if not torch.allclose(y, y_ref, **TOL):
        fail(f"encodec: decode on the card differs from the CPU's by {y_err:.3e}")
    return {"wall": wall, "audio_err": y_err, "lstm_path_err": path_err,
            "lstm_path_shapes": len(path_calls)}


def build_bark(codec):
    """Bark (``suno/bark``'s three GPTs, ``bark_config``) with seeded random
    weights on the card, decoding through ``codec``.  A sampled class 10 000
    (the pad token) stops the semantic stage, so the semantic GPT's final
    layer norm gets a bias of BARK_STOP_LOGIT u for a seeded unit vector u
    and its head's row 10 000 is -u: that logit is -BARK_STOP_LOGIT less the
    normalised state's component along u (about N(0, 1)), against random
    logits of about N(0, 0.33), and every run makes its whole budget."""
    from mlx_audio_tpu_torch.models.tts.bark import Model, bark_config
    from mlx_audio_tpu_torch.models.tts.bark.bark import SEMANTIC_PAD_TOKEN

    t0 = time.perf_counter()
    model = Model(bark_config(), codec=codec, tokenizer=BarkStubTokenizer(),
                  device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        u = torch.randn(model.semantic.lm_head.weight.shape[1], generator=gen,
                        device="cuda")
        u = u / u.norm()
        model.semantic.layernorm_final.bias.copy_(BARK_STOP_LOGIT * u)
        model.semantic.lm_head.weight[SEMANTIC_PAD_TOKEN] = -u
    torch.cuda.synchronize()
    n = sum(p.numel() for k, p in model.state_dict().items() if not k.startswith("_codec"))
    step_bytes = {s: 4 * sum(p.numel() for k, p in getattr(model, s).state_dict().items()
                             if k != "input_embeds_layer.weight")
                  for s in ("semantic", "coarse_acoustics")}
    print(f"Bark built in {time.perf_counter() - t0:.1f} s: {n / 1e9:.3f} B parameters, "
          f"{4 * n / 1e9:.3f} GB float32; a semantic / coarse step reads "
          f"{step_bytes['semantic'] / 1e9:.3f} / {step_bytes['coarse_acoustics'] / 1e9:.3f} "
          f"GB of weights (bound {1e3 * step_bytes['semantic'] / PEAK_BYTES_PER_S:.3f} / "
          f"{1e3 * step_bytes['coarse_acoustics'] / PEAK_BYTES_PER_S:.3f} ms)", flush=True)
    return model


def bark_runs(model, launches: dict, lstm_routes: dict) -> dict:
    """The entry points: a greedy-like generate (semantic BARK_SEMANTIC_STEPS,
    every stage at BARK_GREEDY), generate_batch of 4 texts, one sampled
    generate at the default temperatures.  Each row of the 4-batch's
    semantic tokens must equal its one-row run (the rows share one
    n_valid).  generate is generate_batch([text])[0], so a repeat of the
    greedy-like run through generate_batch([text]) is a determinism check:
    tokens equal, audio within TOL.
    EnCodec's decode must launch lstm, on the row route; lstm is held to its
    plain version on the path's operands."""
    from mlx_audio_tpu_torch.nn import kernels

    seen = {"semantic": [], "codes": []}
    sem_fn, codec = model.generate_text_semantic_batch, model._codec
    decode_fn = codec.decode

    def recording_semantic(*a, **k):
        out = sem_fn(*a, **k)
        seen["semantic"].append([o.tolist() for o in out])
        return out

    def recording_decode(codes, *a, **k):
        seen["codes"].append(torch.as_tensor(codes).cpu().numpy())
        return decode_fn(codes, *a, **k)

    model.generate_text_semantic_batch = recording_semantic
    codec.decode = recording_decode
    path_calls, wall = {}, {}
    run = path_runner(launches, wall)
    lstm = record_lstm_calls(path_calls)
    greedy = dict(temperature=BARK_GREEDY, max_steps=BARK_SEMANTIC_STEPS)
    try:
        single = run_counted(run, "bark_generate", lambda: list(
            model.generate(BARK_TEXT, **greedy)), lstm_routes)
        batch = run_counted(run, "bark_generate_batch", lambda: model.generate_batch(
            BARK_BATCH_TEXTS, **greedy), lstm_routes)
        sampled = run_counted(run, "bark_generate_sampled", lambda: list(model.generate(
            BARK_TEXT, seed=3, max_steps=BARK_SEMANTIC_STEPS)), lstm_routes)
        one = model.generate_batch([BARK_TEXT], **greedy)
    finally:
        del model.generate_text_semantic_batch, codec.decode
        kernels.lstm = lstm
    samples = 3 * BARK_SEMANTIC_STEPS // 2 * 320
    for name, results, n in (("bark generate", single, 1),
                             ("bark generate_batch", batch, len(BARK_BATCH_TEXTS)),
                             ("bark generate (sampled)", sampled, 1),
                             ("bark repeated generate_batch", one, 1)):
        if len(results) != n:
            fail(f"{name}: {len(results)} results for {n} texts")
        for r in results:
            if not (r.samples == samples and np.isfinite(r.audio).all()):
                fail(f"{name}: {r.samples} samples (expected {samples}: a full "
                     "semantic budget), or not finite")
    for sems in seen["semantic"]:
        if any(len(s) != BARK_SEMANTIC_STEPS for s in sems):
            fail(f"bark: semantic lengths {[len(s) for s in sems]}, not the budget")
    if seen["semantic"][3] != seen["semantic"][0]:
        fail(f"bark: a repeat of the greedy-like run differs in its semantic tokens "
             f"after {_shared(seen['semantic'][3][0], seen['semantic'][0][0])}")
    if not np.array_equal(seen["codes"][3], seen["codes"][0]):
        fail("bark: a repeat of the greedy-like run differs in its fine codes")
    a_err = float(np.abs(one[0].audio - single[0].audio).max())
    if not np.allclose(one[0].audio, single[0].audio, atol=TOL["atol"], rtol=TOL["rtol"]):
        fail(f"bark: a repeat of the greedy-like run differs in its audio by {a_err:.3e}")
    for name in ("bark_generate", "bark_generate_batch", "bark_generate_sampled"):
        if launches[name]["lstm"] == 0:
            fail(f"{name}: lstm never launched in its EnCodec decode")
        _check_row_route(name, lstm_routes[name])
    path_err = check_lstm_path(path_calls, lstm, "Bark")
    shared = []
    for text, row in zip(BARK_BATCH_TEXTS, seen["semantic"][1]):
        alone = model.generate_text_semantic(text, temperature=BARK_GREEDY,
                                             max_steps=BARK_SEMANTIC_STEPS).tolist()
        shared.append(_shared(row, alone))
    if min(shared) < BARK_SEMANTIC_STEPS:
        fail(f"bark: the 4-text batch's semantic rows share only {shared} of "
             f"{BARK_SEMANTIC_STEPS} tokens with their one-row runs")
    audio_s = samples / model.sample_rate
    print(f"bark: greedy-like generate of {BARK_SEMANTIC_STEPS} semantic tokens, codes "
          f"{seen['codes'][0].shape}, {audio_s:.3f} s of audio, real-time factor "
          f"{wall['bark_generate'] / audio_s:.4f} (generate's wall time over the audio's "
          f"length); a repeated run repeats it (tokens equal, audio "
          f"{a_err:.3e}); the 4-text batch's semantic rows share {shared} of "
          f"{BARK_SEMANTIC_STEPS} tokens with their one-row runs; lstm by route "
          + json.dumps({k: v for k, v in lstm_routes.items() if k.startswith("bark")})
          + "; wall s: " + ", ".join(f"{k} {v:.3f}" for k, v in wall.items()), flush=True)
    return {"wall": wall, "codes": seen["codes"][0], "semantic": seen["semantic"][0][0],
            "real_time_factor": wall["bark_generate"] / audio_s, "batch_shared": shared,
            "lstm_path_err": path_err, "lstm_path_shapes": len(path_calls)}


def _bark_semantic_state(model, texts, max_steps: int):
    from mlx_audio_tpu_torch.models.tts.bark.bark import _semantic_prefill

    dev = model.device
    encoded = torch.as_tensor(model._text_rows(texts), dtype=torch.long, device=dev)
    hist = torch.as_tensor(model._semantic_history(None), dtype=torch.long, device=dev)
    _, last, caches = _semantic_prefill(model, encoded, hist, 0, max_steps, BARK_GREEDY)
    return caches, last


def _bark_coarse_state(model, semantic, rows: int, steps: int):
    """A first coarse window's prefill over ``rows`` copies of ``semantic``'s
    context, with room for ``steps`` more tokens: (caches, first token)."""
    from mlx_audio_tpu_torch.models.tts.bark.bark import (
        COARSE_INFER_TOKEN,
        COARSE_SEMANTIC_PAD_TOKEN,
        _cache_bucket,
        _coarse_window,
    )

    ctx = np.full(257, COARSE_SEMANTIC_PAD_TOKEN, dtype=np.int64)
    ctx[:len(semantic)] = semantic
    ctx[256] = COARSE_INFER_TOKEN
    x_in = np.full((rows, 384), COARSE_SEMANTIC_PAD_TOKEN, dtype=np.int64)
    x_in[:, :257] = ctx
    toks, caches = _coarse_window(model, torch.as_tensor(x_in, device=model.device), 257,
                                  0, torch.Generator().manual_seed(0), 1,
                                  _cache_bucket(257 + steps + 1), BARK_GREEDY)
    return caches, toks[-1]


def _bark_semantic_rate(model, texts, gen) -> float:
    """Semantic steps/s of ``texts``' batch, BARK_TIMED_STEPS after a
    prefill and one warm step, synced."""
    from mlx_audio_tpu_torch.models.tts.bark.bark import _semantic_chunk

    caches, last = _bark_semantic_state(model, texts, BARK_TIMED_STEPS + 1)
    _semantic_chunk(model, caches, last, gen, 1, BARK_GREEDY)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _semantic_chunk(model, caches, last, gen, BARK_TIMED_STEPS, BARK_GREEDY)
    torch.cuda.synchronize()
    return BARK_TIMED_STEPS / (time.perf_counter() - t0)


def bark_breakdown(model, run: dict) -> dict:
    """The stages apart, synced between them: BARK_TIMED_STEPS semantic
    steps at batch 1 and 4 after a prefill, as many coarse steps at batch 1
    and 4 after a first window's prefill, the fine stage over the greedy
    run's coarse codes (at BARK_GREEDY, with its seed), EnCodec's decode of
    its fine codes; then a profile of PROFILE_STEPS batch-1 semantic steps."""
    from mlx_audio_tpu_torch.models.tts.bark.bark import _coarse_scan, _semantic_chunk

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(0)
    out = {}
    for rows, texts in ((1, [BARK_TEXT]), (4, BARK_BATCH_TEXTS)):
        out[f"semantic_steps_per_s_batch{rows}"] = _bark_semantic_rate(model, texts, gen)
        caches, tok = _bark_coarse_state(model, run["semantic"], rows, BARK_TIMED_STEPS + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _coarse_scan(model, caches, tok, 0, gen, BARK_TIMED_STEPS + 1, BARK_GREEDY)
        torch.cuda.synchronize()
        out[f"coarse_steps_per_s_batch{rows}"] = BARK_TIMED_STEPS / (time.perf_counter() - t0)
        del caches
    coarse = run["codes"][0, 0, :2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fine = model.generate_fine(coarse, temperature=BARK_GREEDY)  # generate's seed 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    audio = model.codec_decode(fine)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not np.array_equal(fine, run["codes"][0, 0]):
        fail("bark: the breakdown's fine stage differs from the greedy run's")
    out.update(fine_s=t1 - t0, encodec_decode_s=t2 - t1,
               audio_s=audio.shape[-1] / model.sample_rate,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("bark breakdown (f32, temperature 1e-6): " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()) + f"; on {gpu_line()}", flush=True)
    caches, last = _bark_semantic_state(model, [BARK_TEXT], PROFILE_STEPS + 2)
    _, caches, last = _semantic_chunk(model, caches, last, gen, 2, BARK_GREEDY)  # warm
    prof = profile_steps("bark semantic", lambda: _semantic_chunk(
        model, caches, last, gen, PROFILE_STEPS, BARK_GREEDY))
    if prof is not None:
        del prof["groups"], prof["device_ms"]
        out.update(prof)
    return out


def _bark_tf_inputs(model, run: dict) -> dict:
    """The greedy run's teacher-forced inputs: the semantic prompt, its
    tokens, the coarse first window's context and tokens, the fine codes."""
    from mlx_audio_tpu_torch.models.tts.bark.bark import (
        CODEBOOK_SIZE,
        COARSE_INFER_TOKEN,
        COARSE_SEMANTIC_PAD_TOKEN,
        SEMANTIC_VOCAB_SIZE,
    )

    sem = run["semantic"]
    codes = run["codes"][0, 0]                       # [8, T]
    ctx = np.full(257, COARSE_SEMANTIC_PAD_TOKEN, dtype=np.int64)
    ctx[:len(sem)] = sem
    ctx[256] = COARSE_INFER_TOKEN
    fine_in = np.full((1, 1024, 8), CODEBOOK_SIZE, dtype=np.int64)
    fine_in[0, :codes.shape[1]] = codes.T
    return {"prompt": model._text_rows([BARK_TEXT]), "hist": model._semantic_history(None),
            "semantic": sem, "ctx": ctx, "fine_in": fine_in,
            "coarse": (codes[:2].T + SEMANTIC_VOCAB_SIZE
                       + np.array([0, CODEBOOK_SIZE])).reshape(-1)}


def _bark_tf_logits(semantic, coarse_gpt, fine_gpt, tf: dict, steps: int) -> list:
    """Float logits of the semantic prompt's prefill and ``steps`` steps,
    the coarse first window's prefill and ``steps`` steps (its semantic and
    coarse classes), and one fine forward (codebook 1), on the CPU; the
    caches in the weights' dtype, as the stages make them."""
    from mlx_audio_tpu_torch.models.tts.bark.bark import (
        CODEBOOK_SIZE,
        SEMANTIC_INFER_TOKEN,
        SEMANTIC_VOCAB_SIZE,
    )

    dev = semantic.lm_head.weight.device
    out = []
    with torch.no_grad():
        emb = semantic.input_embeds_layer
        p = torch.cat([emb(torch.as_tensor(tf["prompt"], device=dev))
                       + emb(torch.as_tensor(tf["hist"], device=dev))[None],
                       emb(torch.tensor([[SEMANTIC_INFER_TOKEN]], device=dev))], 1)
        caches = semantic.init_cache(1, 257 + steps, dtype=emb.weight.dtype)
        lg, caches = semantic.prefill(caches, p, 257)
        out.append(lg)
        for t in tf["semantic"][:steps]:
            lg, caches = semantic.step(caches, torch.tensor([[t]], device=dev))
            out.append(lg)
        x = coarse_gpt.input_embeds_layer(torch.as_tensor(tf["ctx"], device=dev)[None])
        caches = coarse_gpt.init_cache(1, 257 + steps,
                                       dtype=coarse_gpt.input_embeds_layer.weight.dtype)
        lg, caches = coarse_gpt.prefill(caches, x, 257)
        out.append(lg[:, :SEMANTIC_VOCAB_SIZE + 2 * CODEBOOK_SIZE])
        for t in tf["coarse"][:steps]:
            lg, caches = coarse_gpt.step(caches, torch.tensor([[int(t)]], device=dev))
            out.append(lg[:, :SEMANTIC_VOCAB_SIZE + 2 * CODEBOOK_SIZE])
        fl = fine_gpt(1, torch.as_tensor(tf["fine_in"], device=dev))
    return [o.float().cpu() for o in out] + [fl.float().cpu()]


def bark_card_against_cpu(model, run: dict) -> float:
    """The greedy run's tokens fed back, teacher-forced, through the card's
    weights and the same weights on the CPU: the semantic prompt's prefill
    and BARK_TF_STEPS steps, the coarse first window's prefill and as many
    steps, and one fine forward (codebook 1) over the greedy fine codes; the
    logits must agree within TOL.  Returns the largest difference."""
    from mlx_audio_tpu_torch.models.tts.bark import GPT, FineGPT, GPTConfig

    cfg = model.config
    tf = _bark_tf_inputs(model, run)
    t0 = time.perf_counter()
    card = _bark_tf_logits(model.semantic, model.coarse_acoustics, model.fine_acoustics, tf,
                           BARK_TF_STEPS)
    cpu_models = []
    for name, cls, c in (("semantic", GPT, cfg.semantic_config),
                         ("coarse_acoustics", GPT, cfg.coarse_acoustics_config),
                         ("fine_acoustics", FineGPT, cfg.fine_acoustics_config)):
        m = cls(GPTConfig.from_dict(c))
        m.load_state_dict({k: v.cpu() for k, v in getattr(model, name).state_dict().items()})
        cpu_models.append(m)
    cpu = _bark_tf_logits(*cpu_models, tf, BARK_TF_STEPS)
    errs = [float((a - b).abs().max()) for a, b in zip(card, cpu)]
    names = ["semantic"] * (BARK_TF_STEPS + 1) + ["coarse"] * (BARK_TF_STEPS + 1) + ["fine"]
    by_stage = {n: max(e for e, m in zip(errs, names) if m == n) for n in set(names)}
    print(f"bark card against the CPU: teacher-forced logits of the semantic prefill and "
          f"{BARK_TF_STEPS} steps, the coarse first window and {BARK_TF_STEPS} steps, one "
          f"fine forward: max abs diff {json.dumps(by_stage)} (max |logit| "
          f"{max(float(c.abs().max()) for c in cpu):.3f}; atol {TOL['atol']}, rtol "
          f"{TOL['rtol']}) in {time.perf_counter() - t0:.1f} s", flush=True)
    bad = [n for a, b, n in zip(card, cpu, names) if not torch.allclose(a, b, **TOL)]
    if bad:
        fail(f"bark: teacher-forced logits on the card differ from the CPU's in "
             f"{sorted(set(bad))}: {json.dumps(by_stage)}")
    return max(errs)


def vocos_runs(launches: dict) -> dict:
    """Vocos-mel-24kHz (``charactr/vocos-mel-24khz``'s config) with seeded
    random weights: ``Vocos(audio)`` on VOCOS_SECONDS of seeded audio and
    ``decode`` of its mel, timed, the route of every conv printed; the same
    through the same weights on the CPU: audio within TOL."""
    from mlx_audio_tpu_torch.codec.vocos import Vocos, vocos_mel_24khz_config
    from mlx_audio_tpu_torch.nn import layers

    config = vocos_mel_24khz_config()
    vocos = Vocos.from_hparams(config, device="cuda", seed=0)
    sr = config["feature_extractor"]["init_args"]["sample_rate"]
    audio = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (1, int(VOCOS_SECONDS * sr))) * 0.1, dtype=torch.float32)
    routes, wall = {}, {}
    run = path_runner(launches, wall)
    route_fn = route_recorder(routes)
    try:
        y = run("vocos_call", lambda: vocos(audio))
        mel = vocos.feature_extractor(audio.cuda())
        y2 = run("vocos_decode", lambda: vocos.decode(mel))
    finally:
        layers.conv1d_route = route_fn
    frames = audio.shape[1] // 256
    if mel.shape != (1, frames, 100) or y.shape != (1, (frames - 1) * 256):
        fail(f"vocos: mel {tuple(mel.shape)}, audio {tuple(y.shape)}")
    print_routes("vocos", routes)
    t0 = time.perf_counter()
    ref = cpu_twin(lambda: Vocos.from_hparams(config, device="cpu"), vocos)
    y_ref, y2_ref = ref(audio), ref.decode(mel.cpu())
    cpu_s = time.perf_counter() - t0
    errs = [float((a.cpu() - b).abs().max()) for a, b in ((y, y_ref), (y2, y2_ref))]
    print(f"vocos ({VOCOS_SECONDS} s at {sr} Hz): mel {tuple(mel.shape)}, audio "
          f"{tuple(y.shape)}; wall s: " + ", ".join(f"{k} {v:.4f}" for k, v in wall.items())
          + f"; against the CPU ({cpu_s:.1f} s): Vocos(audio) {errs[0]:.3e}, decode "
          f"{errs[1]:.3e} (max |audio| {float(y_ref.abs().max()):.4f}; atol "
          f"{TOL['atol']}, rtol {TOL['rtol']})", flush=True)
    for (a, b), what in zip(((y, y_ref), (y2, y2_ref)), ("Vocos(audio)", "decode")):
        if not (bool(torch.isfinite(a).all()) and torch.allclose(a.cpu(), b, **TOL)):
            fail(f"vocos: {what} on the card differs from the CPU's, or not finite")
    return {"wall": wall, "audio_err": max(errs)}


# ---------------------------------------------------------------------------
# phase 9: Spark-TTS-0.5B int8 with BiCodec and wav2vec2-large-xlsr-53
# ---------------------------------------------------------------------------

# semantic tokens a run: 2.2 s at 50 a second; the wave generator's C = 384
# stage then holds 4 400 rows, past the banded route's 4 096
SPARK_SEMANTIC = 110
SPARK_GLOBAL = 32  # the global tokens BiCodec's speaker encoder speaks
SPARK_TOKENS = SPARK_GLOBAL + SPARK_SEMANTIC  # generated a run
SPARK_TEXT = ORPHEUS_TEXT
SPARK_BATCH_TEXTS = CSM_BATCH_TEXTS
SPARK_REF_SECONDS = 6.0  # the voice-clone reference clip
SPARK_REF_TEXT = CSM_REF_TEXT
SPARK_STOPS = (151_645, 128_258)  # <|im_end|> and the end-of-speech token
SPARK_TIE = 1e-5  # a token may differ from the CPU's where its margin is this or less
SPARK_TF_STEPS = 8  # teacher-forced steps held against the CPU, to TOL
SPARK_EMBED_SCALE = 0.05  # the tied embedding's scale (build_spark)
# the fewest distinct tokens a greedy run must have: at the init's scale the
# LM repeats one token; with the penalty's window of 20 a run cycles through
# a few dozen
SPARK_DISTINCT = 16


class SparkStubTokenizer:
    """``tokenizer(text, return_tensors="np").input_ids``: each ``<|...|>``
    token of Spark's vocabulary one id, every other character one, below
    Qwen2's 151 643 text ids; ``decode``: a run's first 32 ids as
    ``<|bicodec_global_i|>``, the rest as ``<|bicodec_semantic_j|>``, so
    that a run of SPARK_TOKENS parses to 32 global and SPARK_SEMANTIC
    semantic tokens."""

    def __call__(self, text: str, return_tensors=None):
        import re
        import zlib
        from types import SimpleNamespace

        ids = [1_000 + zlib.crc32(m.group(0).encode()) % 120_000
               for m in re.finditer(r"<\|[^|]*\|>|.", text, re.S)]
        return SimpleNamespace(input_ids=np.asarray([ids], dtype=np.int64))

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return ("".join(f"<|bicodec_global_{i % 4096}|>" for i in ids[:SPARK_GLOBAL])
                + "".join(f"<|bicodec_semantic_{i % 8192}|>" for i in ids[SPARK_GLOBAL:]))


def build_spark():
    """Spark-TTS-0.5B at the published widths (ModelConfig's defaults) with
    seeded random weights on the card: the Qwen2-0.5B LM, its tied
    embedding scaled and its stop rows at 0, int8 in groups of 64; BiCodec
    at DEFAULT_BICODEC_CONFIG; wav2vec2 at wav2vec2-large-xlsr-53's
    widths."""
    from mlx_audio_tpu_torch.models.tts.spark import Model, ModelConfig
    from mlx_audio_tpu_torch.nn.quantize import quantize_model

    t0 = time.perf_counter()
    model = Model(ModelConfig(), tokenizer=SparkStubTokenizer(), device="cuda")
    # At the init's scale the embedding of the token just fed back dominates
    # the last hidden state, and the tied head gives it the top logit even
    # after the repetition penalty: greedy decoding repeats one token.  At a
    # twentieth of it the layers' outputs set the next token (the twins
    # scale the tiny LM's embedding so too).  A trained Spark ends its
    # speech with one of the stop tokens; random weights would emit them at
    # random, so their rows are held at 0: logit 0, below the top of 166 000
    # random ones.
    with torch.no_grad():
        model.lm.model.embed_tokens.weight.mul_(SPARK_EMBED_SCALE)
        model.lm.model.embed_tokens.weight[list(SPARK_STOPS)] = 0
    quantize_model(model.lm, group_size=64, bits=8)
    w2v = model._audio_tokenizer.feature_extractor
    nbytes = {name: sum(t.numel() * t.element_size() for t in m.state_dict().values())
              for name, m in (("LM", model.lm), ("BiCodec", model.bicodec), ("wav2vec2", w2v))}
    print(f"Spark-TTS-0.5B built (LM int8, groups of 64) in "
          f"{time.perf_counter() - t0:.1f} s; state GB: "
          + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in nbytes.items()), flush=True)
    return model


def _spark_rows(model, texts):
    """The prompt ids the control-mode entry points build (male, moderate)."""
    return [model._ids(model.process_prompt_control("male", "moderate", "moderate", t))
            for t in texts]


def _spark_clip():
    rng = np.random.default_rng(5)
    return (rng.standard_normal(int(SPARK_REF_SECONDS * 16_000)) * 0.1).astype(np.float32)


def _check_spark(name, results, n):
    if len(results) != n:
        fail(f"{name}: {len(results)} results for {n} texts")
    for r in results:
        if not (r.token_count == SPARK_SEMANTIC and r.samples == 320 * SPARK_SEMANTIC
                and np.isfinite(r.audio).all()):
            fail(f"{name}: {r.token_count} semantic tokens, {r.samples} samples, or "
                 "not finite")


def spark_runs(model, launches: dict) -> dict:
    """The entry points: greedy control-mode generate of SPARK_TOKENS,
    generate_batch of 4 texts, one sampled generate at the defaults
    (temperature 0.8, top-k 50, top-p 0.95, penalty 1.3), a greedy
    voice-clone generate from a seeded SPARK_REF_SECONDS clip; then a
    one-prompt generate_tokens_batch against the greedy run, and each batch
    row against its one-row run.  Every conv's route is printed; the
    kernels are held to their plain versions on the path's operands."""
    from mlx_audio_tpu_torch.models.lm import causal
    from mlx_audio_tpu_torch.models.tts.spark import spark as spark_mod
    from mlx_audio_tpu_torch.nn import kernels, layers

    tokens, batch_tokens, detok = [], [], []
    gen_fn, batch_fn = spark_mod.generate_tokens, spark_mod.generate_tokens_batch
    detok_fn = model.bicodec.detokenize

    def recording_gen(*a, **k):
        toks = []
        tokens.append(toks)
        for chunk in gen_fn(*a, **k):
            toks.extend(int(t) for t in chunk)
            yield chunk

    def recording_batch(*a, **k):
        outs = batch_fn(*a, **k)
        batch_tokens.append([o.tolist() for o in outs])
        return outs

    def recording_detok(semantic, global_):
        detok.append((np.asarray(semantic), np.asarray(global_)))
        return detok_fn(semantic, global_)

    path_calls, conv_calls, routes = {}, {}, {}
    qmm = record_qmm_calls(path_calls)
    convs = record_conv_calls(conv_calls)
    route_fn = route_recorder(routes)
    spark_mod.generate_tokens, spark_mod.generate_tokens_batch = recording_gen, recording_batch
    model.bicodec.detokenize = recording_detok
    wall = {}
    run = path_runner(launches, wall)
    kw = dict(max_tokens=SPARK_TOKENS)
    clip = _spark_clip()
    try:
        greedy = run("spark_generate", lambda: list(
            model.generate(SPARK_TEXT, temperature=0.0, **kw)))
        batch = run("spark_generate_batch", lambda: model.generate_batch(
            SPARK_BATCH_TEXTS, temperature=0.0, **kw))
        sampled = run("spark_generate_sampled", lambda: list(
            model.generate(SPARK_TEXT, seed=3, **kw)))
        clone = run("spark_generate_clone", lambda: list(model.generate(
            SPARK_TEXT, ref_audio=clip, ref_text=SPARK_REF_TEXT, temperature=0.0, **kw)))
    finally:
        kernels.quantized_matmul = qmm
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
        layers.conv1d_route = route_fn
        spark_mod.generate_tokens, spark_mod.generate_tokens_batch = gen_fn, batch_fn
        model.bicodec.detokenize = detok_fn
    _check_spark("spark generate", greedy, 1)
    _check_spark("spark generate_batch", batch, len(SPARK_BATCH_TEXTS))
    _check_spark("spark generate (sampled)", sampled, 1)
    _check_spark("spark generate (clone)", clone, 1)
    names = ("spark_generate", "spark_generate_batch", "spark_generate_sampled",
             "spark_generate_clone")
    for name in names:
        missing = [k for k in ("quantized_matmul", "banded_conv1d", "dilated_conv1d")
                   if launches[name][k] == 0]
        if missing:
            fail(f"{name}: kernels never launched: {missing}")
        stray = [k for k in ("lstm", "depth_draft") if launches[name][k]]
        if stray:
            fail(f"{name}: kernels off Spark's path launched: {stray}")
    if any(len(t) != SPARK_TOKENS for t in tokens):
        fail(f"spark: runs of {[len(t) for t in tokens]} tokens, not {SPARK_TOKENS}")
    distinct = [len(set(t)) for t in tokens]
    if min(distinct[0], distinct[-1]) < SPARK_DISTINCT:
        fail(f"spark: the greedy runs have {distinct[0]} and {distinct[-1]} distinct "
             f"tokens of {SPARK_TOKENS}: the LM repeats itself")
    print_routes("spark", routes)
    path_err = check_qmm_path(path_calls, qmm, "Spark")
    conv_err = check_conv_path(conv_calls, convs, "Spark")

    gkw = dict(max_tokens=SPARK_TOKENS, temperature=0.0, repetition_penalty=1.3,
               stop_tokens=SPARK_STOPS)
    rows = _spark_rows(model, [SPARK_TEXT] + SPARK_BATCH_TEXTS)
    one_row = causal.generate_tokens_batch(model.lm, rows[:1], **gkw)[0].tolist()
    if one_row != tokens[0]:
        fail(f"spark: a one-prompt generate_tokens_batch differs from generate_tokens "
             f"after {_shared(one_row, tokens[0])} of {len(tokens[0])} tokens")
    shared = []
    for prompt, row in zip(rows[1:], batch_tokens[0]):
        alone = [t for c in causal.generate_tokens(model.lm, prompt, **gkw) for t in c]
        shared.append(_shared(row, alone))
    clone_global = detok[-1][1]
    audio_s = greedy[0].samples / model.sample_rate
    print(f"spark: greedy {len(tokens[0])} tokens, distinct tokens of the greedy, "
          f"sampled and clone runs {distinct}, "
          f"{SPARK_SEMANTIC} semantic, {audio_s:.3f} s of audio, real-time factor "
          f"{wall['spark_generate'] / audio_s:.4f} (generate's wall time over the audio's "
          f"length); a one-prompt generate_tokens_batch equals generate_tokens; the 4-row "
          f"batch's rows share {shared} of {SPARK_TOKENS} tokens with their one-row runs; "
          f"the clone run decoded with the reference's {clone_global.shape[-1]} global "
          f"tokens; wall s: " + ", ".join(f"{k} {v:.3f}" for k, v in wall.items()),
          flush=True)
    return {"wall": wall, "qmm_path_err": path_err, "qmm_path_shapes": len(path_calls),
            "conv_path_err": conv_err, "conv_path_shapes": _per_kernel(conv_calls),
            "batch_shared": shared, "greedy_tokens": tokens[0], "greedy_detok": detok[0],
            "greedy_audio": greedy[0].audio, "clip": clip,
            "real_time_factor": wall["spark_generate"] / audio_s}


def spark_tokenize_against_cpu(model, run: dict) -> dict:
    """BiCodecTokenizer.tokenize of the clone run's clip, and detokenize of
    the greedy run's tokens, on the card and through the same weights on
    the CPU.  The mixed wav2vec2 features and the audio must agree within
    TOL; a semantic or global token may differ only where the CPU's
    winner beats its runner-up by SPARK_TIE or less (the near-ties are
    counted and printed)."""
    from mlx_audio_tpu_torch.models.stt.wav2vec import Wav2Vec2Model
    from mlx_audio_tpu_torch.models.tts.spark import BiCodec
    from mlx_audio_tpu_torch.models.tts.spark.audio_tokenizer import BiCodecTokenizer

    tok = model._audio_tokenizer
    w2v = tok.feature_extractor
    t0 = time.perf_counter()
    cpu_codec = cpu_twin(lambda: BiCodec(model.bicodec.config, device="cpu"), model.bicodec)
    cpu_w2v = cpu_twin(lambda: Wav2Vec2Model(w2v.config, device="cpu"), w2v)
    cpu_tok = BiCodecTokenizer(cpu_codec, cpu_w2v, config=tok.config)

    def tokens(t):
        wav, ref = t.process_audio(run["clip"])
        feat = t.extract_wav2vec2_features(wav[None])
        semantic, global_ = t.model.tokenize(feat, ref)
        return feat.cpu(), semantic.cpu(), global_.cpu(), ref

    feat, sem, glo, ref = tokens(tok)
    feat_c, sem_c, glo_c, _ = tokens(cpu_tok)
    with torch.no_grad():
        # the CPU's margins: cosine distances to the codebook, and each
        # global token's FSQ dimensions against their rounding boundary
        q = cpu_codec.quantizer
        dist = q.distances(q._in(cpu_codec.encoder(feat_c)))
        two = torch.topk(dist, 2, dim=-1, largest=False).values
        sem_margin = two[..., 1] - two[..., 0]
        se = cpu_codec.speaker_encoder
        _, latent = se.speaker_encoder(cpu_codec.get_mel_spectrogram(ref), return_latent=True)
        fsq = se.quantizer
        bound = fsq.layers[0].bound(fsq.project_in(se.perceiver_sampler(latent))
                                    / fsq.scales[0])
        frac = (bound - torch.round(bound)).abs()
        glo_margin = (1 - 2 * frac).min(-1).values
        y_c = cpu_codec.detokenize(*run["greedy_detok"])[0].numpy()
    cpu_s = time.perf_counter() - t0
    out = {}
    for name, a, b, margin in (("semantic", sem, sem_c, sem_margin),
                               ("global", glo, glo_c, glo_margin)):
        differ = a != b
        ties = margin <= SPARK_TIE
        if bool((differ & ~ties).any()):
            i = int((differ & ~ties).nonzero()[0][-1])
            fail(f"spark tokenize: {name} token {i} differs from the CPU's ({int(a[0, i])} "
                 f"against {int(b[0, i])}) with a margin of {float(margin[0, i]):.3e}")
        out[name] = {"tokens": a.numel(), "differ": int(differ.sum()),
                     "near_ties": int(ties.sum()), "min_margin": float(margin.min())}
    feat_err = float((feat - feat_c).abs().max())
    audio = run["greedy_audio"]
    audio_err = float(np.abs(audio - y_c).max())
    print(f"spark card against the CPU ({cpu_s:.1f} s): tokenize of the "
          f"{SPARK_REF_SECONDS} s clip: features {tuple(feat.shape)} max abs diff "
          f"{feat_err:.3e} (max |feature| {float(feat_c.abs().max()):.3f}); tokens "
          f"{json.dumps(out)} (a token may differ where its margin is {SPARK_TIE} or "
          f"less); detokenize of the greedy run's {SPARK_SEMANTIC} tokens: audio max abs "
          f"diff {audio_err:.3e} (max |audio| {float(np.abs(y_c).max()):.4f}); atol "
          f"{TOL['atol']}, rtol {TOL['rtol']}", flush=True)
    if not torch.allclose(feat, feat_c, **TOL):
        fail(f"spark: the wav2vec2 features on the card differ from the CPU's by {feat_err:.3e}")
    if not np.allclose(audio, y_c, **TOL):
        fail(f"spark: detokenize on the card differs from the CPU's by {audio_err:.3e}")
    return {"feature_err": feat_err, "audio_err": audio_err, "tokens": out}


def spark_breakdown(model, run: dict) -> dict:
    """The LM loop's breakdown (lm_breakdown, with the BiCodec decode as its
    codec), the profile of PROFILE_STEPS decode steps, and the time of
    tokenize (wav2vec2, BiCodec's encoder and speaker encoder) of the clip
    and of detokenize of the greedy run's tokens."""
    from mlx_audio_tpu_torch.models.tts.spark.token_parser import parse_generated_tokens

    def synthesize(toks):
        sem, glo = parse_generated_tokens(model.tokenizer.decode(toks))
        return model._audio_tokenizer.detokenize(np.asarray([glo]), np.asarray([sem]))

    out = lm_breakdown("spark", model.lm, _spark_rows(model, [SPARK_TEXT]),
                       _spark_rows(model, SPARK_BATCH_TEXTS), SPARK_TOKENS, 1.3, 20,
                       synthesize, model.sample_rate)
    tok = model._audio_tokenizer
    for name, fn in (("tokenize_s", lambda: tok.tokenize(run["clip"])),
                     ("detokenize_s", lambda: tok.model.detokenize(*run["greedy_detok"]))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    print(f"spark: tokenize of the {SPARK_REF_SECONDS} s clip {out['tokenize_s']:.4f} s, "
          f"detokenize of {SPARK_SEMANTIC} tokens {out['detokenize_s']:.4f} s (warm, "
          f"synced); on {gpu_line()}", flush=True)
    return out


def spark_card_against_cpu(model, run: dict) -> float:
    """The greedy run's prompt and tokens fed, teacher-forced, through the
    card's int8 LM and a copy on the CPU (the kernel's plain version):
    the prefill's logits and SPARK_TF_STEPS steps' must agree within TOL.
    Returns the largest difference."""
    import copy

    from mlx_audio_tpu_torch.models.lm import causal

    prompt = _spark_rows(model, [SPARK_TEXT])[0]
    toks = run["greedy_tokens"][:SPARK_TF_STEPS]

    def logits(lm):
        dev = lm.model.rope_cos.device
        caches, pad_len, ids, _, _ = causal._start(lm, [prompt], SPARK_TF_STEPS, None, 1.0, 1)
        out = [causal._prefill(lm, caches, pad_len, ids)]
        with torch.no_grad():
            for t in toks:
                h, _ = lm.model.step(caches, torch.tensor([[t]], device=dev), pad_len)
                out.append(lm.logits(h[:, -1]).float())
        return torch.cat([o.cpu() for o in out])

    t0 = time.perf_counter()
    card = logits(model.lm)
    cpu = logits(copy.deepcopy(model.lm).cpu())
    err = float((card - cpu).abs().max())
    print(f"spark card against the CPU: the int8 LM's prefill and {SPARK_TF_STEPS} "
          f"teacher-forced steps of the greedy tokens, logits {tuple(card.shape)} max abs "
          f"diff {err:.3e} (max |logit| {float(cpu.abs().max()):.3f}; atol {TOL['atol']}, "
          f"rtol {TOL['rtol']}) in {time.perf_counter() - t0:.1f} s", flush=True)
    if not torch.allclose(card, cpu, **TOL):
        fail(f"spark: teacher-forced logits on the card differ from the CPU's by {err:.3e}")
    return err


# ---------------------------------------------------------------------------
# phase 10: Whisper-large-v3-turbo and Voxtral-Mini-3B
# ---------------------------------------------------------------------------

# mlx-community/whisper-large-v3-turbo's dims
WHISPER_DIMS = dict(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20,
                    n_audio_layer=32, n_vocab=51_866, n_text_ctx=448, n_text_state=1280,
                    n_text_head=20, n_text_layer=4)
WHISPER_SECONDS = 60.0  # the generate clip: two 30 s seek windows
WHISPER_BATCH = 4  # windows a batched decode
WHISPER_BEAM = 5
WHISPER_SAMPLE_LEN = 224  # tokens a window decodes (n_text_ctx // 2)
WHISPER_TF_STEPS = 8  # teacher-forced steps held against the CPU, to TOL
WHISPER_TIE = 1e-5  # a token may differ from the CPU's where its margin is this or less
# build_whisper's arrangement of the random weights (see there)
WHISPER_EMBED_SCALE = 0.05
WHISPER_LN_SHIFT = 0.05
WHISPER_TS_STEP = 1e-3
WHISPER_END_POS_SCALE = 200.0
WHISPER_END_ROW_SCALE = 5.0
# Voxtral-Mini-3B (mistralai/Voxtral-Mini-3B-2507): AudioConfig's defaults,
# the published text config with its head_dim of 128 given (TextConfig
# leaves it unset and would derive 3072 / 32 = 96)
VOXTRAL_TEXT = {"head_dim": 128}
VOXTRAL_EOS = 2
VOXTRAL_EMBED_SCALE = 10.0  # the LM embedding's scale against the init's (build_voxtral)
VOXTRAL_TOKENS = 40  # generated a window (a profile's 32 steps and 2 to warm fit in)
VOXTRAL_SECONDS = 30.0  # one window; the two-window clip is twice as long
VOXTRAL_QMM_PER_STEP = 30 * 7 + 1  # 7 projections a layer and the head
WHISPER_KERNEL_STRAYS = ("banded_conv1d", "lstm", "depth_draft")


class WhisperStubEncoding:
    """The multilingual Whisper vocabulary's layout without its BPE table (no
    tokenizer files, nor tiktoken, need be on the card's machine): ids below
    256 are bytes, every other id below 50 257 decodes to a word of its own
    (" w<id>"), and the special tokens follow at their published ids
    (<|endoftext|> 50 257, <|startoftranscript|> 50 258, 100 languages,
    <|0.00|> 50 365 to <|30.00|> 51 865)."""

    n_base = 50_257

    def __init__(self, num_languages: int = 100):
        from mlx_audio_tpu_torch.models.stt.whisper.tokenizer import whisper_special_tokens

        self._ids = {t: self.n_base + i
                     for i, t in enumerate(whisper_special_tokens(num_languages))}
        self._names = {i: t for t, i in self._ids.items()}
        self.special_tokens_set = set(self._ids)
        self.n_vocab = self.n_base + len(self._ids)
        self.eot_token = self._ids["<|endoftext|>"]

    def encode_single_token(self, token: str) -> int:
        return self._ids[token]

    def encode(self, text: str, **kwargs) -> list:
        return list(text.encode("utf-8"))

    def decode(self, ids, **kwargs) -> str:
        out, run = [], bytearray()
        for i in ids:
            if i < 256:
                run.append(i)
                continue
            out.append(run.decode("utf-8", "replace"))
            run = bytearray()
            out.append(self._names.get(i, f" w{i}"))
        return "".join(out) + run.decode("utf-8", "replace")


def _clip(seed: int, seconds: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * 16_000)) * 0.1).astype(np.float32)


def _timed(fn) -> float:
    """Wall seconds of a warm, synced call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def build_whisper(dims=WHISPER_DIMS):
    """Whisper-large-v3-turbo at the published dims (or ``dims``, a depth
    cut: phase 18) with seeded random
    weights on the card, f32, and the stub tokenizer.  The weights are
    arranged so that every decode runs its whole budget of 224 tokens and
    ends a window with a lone timestamp, Whisper's sign that the window was
    consumed (a 60 s clip is then two seek windows):

    * the tied embedding's rows at a twentieth of the init's scale, so the
      layers, not the token fed back, set the next token;
    * the rows of <|endoftext|> and of every timestamp but <|30.00|> are
      -(1 + 1e-3 i) times the ones vector, and the final layer norm's bias
      0.05 times it: their logits are -64 - 0.064 i (the normed hidden
      state sums to 0), far below the text tokens', so no decode ends
      early and no timestamp pair cuts a window; the first token, where
      the rules allow timestamps only, is <|0.00|>;
    * <|30.00|>'s row is that of i = 0 plus 5 u, u a unit vector that sums
      to 0, and the positional embedding at the last step's position (the
      sot sequence's 3 tokens plus 222) is 200 u: there its logit is about
      +115, elsewhere about -64 +- 5;
    * the positional embedding (0 at the JAX package's init) elsewhere
      drawn from N(0, 1), so that the text tokens change from position to
      position."""
    from mlx_audio_tpu_torch.models.stt.whisper import Model, ModelDimensions
    from mlx_audio_tpu_torch.models.stt.whisper.tokenizer import Tokenizer

    t0 = time.perf_counter()
    model = Model(ModelDimensions(**dims), device="cuda", seed=0)
    tok = Tokenizer(encoding=WhisperStubEncoding(model.num_languages),
                    num_languages=model.num_languages, language="en", task="transcribe")
    model._tokenizer = lambda language=None, task=None: tok
    dec = model.decoder
    d = dims["n_text_state"]
    g = torch.Generator(device="cuda").manual_seed(1)
    u = torch.randn(d, generator=g, device="cuda")
    u = (u - u.mean()) / (u - u.mean()).norm()
    ones = torch.ones(d, device="cuda")
    ts0, last = tok.timestamp_begin, dims["n_vocab"] - 1
    end_pos = len(tok.sot_sequence) + WHISPER_SAMPLE_LEN - 2
    with torch.no_grad():
        emb = dec.token_embedding.weight
        emb.mul_(WHISPER_EMBED_SCALE)
        steps = torch.arange(last + 1 - ts0, device="cuda", dtype=torch.float32)
        emb[ts0:] = -(1.0 + WHISPER_TS_STEP * steps)[:, None] * ones
        emb[tok.eot] = -2.0 * ones
        emb[last] = -ones + WHISPER_END_ROW_SCALE * u
        dec.ln.bias.fill_(WHISPER_LN_SHIFT)
        dec.positional_embedding.normal_(generator=g)
        dec.positional_embedding[end_pos] = WHISPER_END_POS_SCALE * u
    nbytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    print(f"Whisper-large-v3-turbo built (f32, {nbytes / 1e9:.3f} GB) in "
          f"{time.perf_counter() - t0:.1f} s; conv1 route "
          f"{_route_of(model.encoder.conv1, 3000)}", flush=True)
    return model, tok


def _route_of(conv, length: int) -> str:
    from mlx_audio_tpu_torch.nn.layers import conv1d_route

    c_out, c, k = conv.weight.shape
    return conv1d_route(k, c, c_out, length, conv.dilation, conv.stride, conv.groups,
                        conv.padding)


def _count_calls(module, counter: dict):
    """Count the calls of ``module``; returns the undo."""
    fwd = module.forward

    def counting(*a, **k):
        counter["n"] += 1
        return fwd(*a, **k)

    module.forward = counting
    return lambda: delattr(module, "forward")


def _check_window_tokens(name: str, tokens, tok) -> None:
    end = WHISPER_DIMS["n_vocab"] - 1
    inner = tokens[1:-1]
    if not (len(tokens) == WHISPER_SAMPLE_LEN and tokens[0] == tok.timestamp_begin
            and tokens[-1] == end and tok.eot not in inner
            and all(t < tok.timestamp_begin for t in inner)):
        fail(f"{name}: a window decoded {len(tokens)} tokens "
             f"({tokens[:2]} ... {tokens[-2:]}; {tok.eot in inner} EOT inside, "
             f"timestamps inside {[t for t in inner if t >= tok.timestamp_begin][:4]}), "
             f"not <|0.00|>, {WHISPER_SAMPLE_LEN - 2} tokens without EOT or "
             "timestamps, and <|30.00|>")


def whisper_runs(model, tok, launches: dict) -> dict:
    """The entry points: generate of a seeded 60 s clip (greedy, word
    timestamps, two seek windows), decode of a batch of 4 windows, a beam
    search (beam 5) on one window.  dilated_conv1d must launch once in
    every encode (conv1), no kernel off Whisper's path ever; the conv
    kernel is held to its plain version on the path's operands."""
    from mlx_audio_tpu_torch.models.stt.whisper import DecodingOptions
    from mlx_audio_tpu_torch.models.stt.whisper.audio import log_mel_spectrogram
    from mlx_audio_tpu_torch.nn import kernels, layers

    clip = _clip(6, WHISPER_SECONDS)
    long_mel = log_mel_spectrogram(_clip(7, 30.0 * WHISPER_BATCH), n_mels=128, device="cuda")
    mel4 = long_mel[:3000 * WHISPER_BATCH].reshape(WHISPER_BATCH, 3000, 128).contiguous()
    encodes, counts, wall, conv_calls, routes = {"n": 0}, {}, {}, {}, {}
    undo = _count_calls(model.encoder, encodes)
    convs = record_conv_calls(conv_calls)
    route_fn = route_recorder(routes)
    run = path_runner(launches, wall)

    def counted(name, fn):
        encodes["n"] = 0
        out = run(name, fn)
        counts[name] = encodes["n"]
        return out

    torch.cuda.reset_peak_memory_stats()
    try:
        with torch.no_grad():
            out = counted("whisper_generate", lambda: model.generate(
                clip, temperature=0.0, word_timestamps=True, language="en",
                condition_on_previous_text=False))
            batch = counted("whisper_decode_batch", lambda: model.decode(
                mel4, DecodingOptions(language="en")))
            beam = counted("whisper_beam", lambda: model.decode(
                mel4[0], DecodingOptions(language="en", beam_size=WHISPER_BEAM)))
    finally:
        undo()
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
        layers.conv1d_route = route_fn
    peak = torch.cuda.max_memory_allocated() / 1e9
    segs = out.segments
    if [s["seek"] for s in segs] != [0, 3000]:
        fail(f"whisper generate: seek windows at {[s['seek'] for s in segs]}, not [0, 3000]")
    for s in segs:
        _check_window_tokens("whisper generate", s["tokens"], tok)
        if len(s["words"]) < 2 or not all(
                0.0 <= w["start"] <= w["end"] <= WHISPER_SECONDS for w in s["words"]):
            fail(f"whisper generate: the window at {s['seek'] / 100} s has words "
                 f"{s['words'][:2]}")
    for i, r in enumerate(batch):
        _check_window_tokens(f"whisper decode, window {i}", r.tokens, tok)
    _check_window_tokens("whisper beam search", beam.tokens, tok)
    for name in counts:
        lc = launches[name]
        if counts[name] < 1 or lc["dilated_conv1d"] != counts[name]:
            fail(f"{name}: {lc['dilated_conv1d']} dilated_conv1d launches in "
                 f"{counts[name]} encodes")
        stray = [k for k in WHISPER_KERNEL_STRAYS + ("quantized_matmul",) if lc[k]]
        if stray:
            fail(f"{name}: kernels off Whisper's path launched: {stray}")
    print_routes("whisper", routes)
    conv_err = check_conv_path(conv_calls, convs, "Whisper")
    rtf = wall["whisper_generate"] / WHISPER_SECONDS
    words = sum(len(s["words"]) for s in segs)
    distinct = len(set(segs[0]["tokens"]))
    print(f"whisper: generate of {WHISPER_SECONDS} s: {len(segs)} seek windows of "
          f"{WHISPER_SAMPLE_LEN} tokens ({distinct} distinct in the first), {words} "
          f"timed words, real-time factor {rtf:.4f} (generate's wall time over the "
          f"audio's length); decode of {WHISPER_BATCH} windows and a beam-{WHISPER_BEAM} "
          f"search, each {WHISPER_SAMPLE_LEN} tokens; encodes {json.dumps(counts)}; "
          f"peak memory {peak:.2f} GB; wall s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in wall.items()), flush=True)
    return {"wall": wall, "conv_path_err": conv_err, "conv_path_shapes": _per_kernel(conv_calls),
            "clip": clip, "mel4": mel4, "tokens": segs[0]["tokens"], "encodes": counts,
            "real_time_factor": rtf, "peak_memory_gb": peak, "words": words}


def _whisper_filters(model, tok, dev):
    """The greedy decode's logit filters as api.decode builds them for
    DecodingOptions(language="en")."""
    from mlx_audio_tpu_torch.models.stt.whisper import DecodingOptions, api
    from mlx_audio_tpu_torch.models.stt.whisper.decoding import FilterConfig

    v = WHISPER_DIMS["n_vocab"]
    sup = torch.zeros(v)
    sup[list(api._suppress_token_list(tok, DecodingOptions(language="en")))] = float("-inf")
    blank = torch.zeros(v)
    blank[tok.encode(" ") + [tok.eot]] = float("-inf")
    cfg = FilterConfig(eot=tok.eot, timestamp_begin=tok.timestamp_begin,
                       no_timestamps=tok.no_timestamps,
                       max_initial_timestamp_index=round(1.0 / (30 / model.dims.n_audio_ctx)),
                       apply_timestamp_rules=True)
    return cfg, sup.to(dev), blank.to(dev)


def _whisper_tf(model, tok, feats, tokens, n_steps, filtered=False):
    """Teacher-forced decode of one window: the sot sequence prefilled, then
    ``tokens`` fed a step at a time; each step's logits (raw, or through
    the greedy loop's filters) on the CPU."""
    from mlx_audio_tpu_torch.models.stt.whisper.decoding import apply_filters

    dec = model.decoder
    dev = feats.device
    sot = list(tok.sot_sequence)
    buf = torch.tensor([sot + list(tokens)], device=dev)
    cfg, sup, blank = _whisper_filters(model, tok, dev)
    out = []
    with torch.no_grad():
        ckv = dec.compute_cross_kv(feats)
        caches = dec.init_cache(1, buf.shape[1] + 1, dtype=feats.dtype)
        dec.prefill(caches, buf[:, :len(sot)], len(sot), ckv)
        for t in range(len(sot), len(sot) + n_steps):
            logits, caches = dec.step(caches, buf[:, t - 1:t], ckv)
            if filtered:
                logits = apply_filters(logits.float(), buf, t, len(sot), cfg, sup, blank)
            out.append(logits.float().cpu())
    return torch.cat(out)


def _tie_check(name: str, card_tokens, cpu_logits, tie: float) -> dict:
    """The card's tokens against the CPU's argmax over the same steps: equal
    wherever the CPU's winner beats its runner-up by more than ``tie``."""
    two = torch.topk(cpu_logits, 2, dim=-1).values
    margin = two[:, 0] - two[:, 1]
    cpu_tok = cpu_logits.argmax(-1)
    card = torch.as_tensor(card_tokens)
    differ = cpu_tok != card
    ties = margin <= tie
    if bool((differ & ~ties).any()):
        i = int((differ & ~ties).nonzero()[0][0])
        fail(f"{name}: token {i} is {int(card[i])} on the card and {int(cpu_tok[i])} on "
             f"the CPU, whose margin is {float(margin[i]):.3e}")
    return {"tokens": len(card), "differ": int(differ.sum()), "near_ties": int(ties.sum()),
            "min_margin": float(margin.min())}


def whisper_card_against_cpu(model, tok, run: dict) -> dict:
    """Through the same weights on the card and the CPU: the log-mel of the
    60 s clip, the encoder's output on its first window, the decoder's
    logits over WHISPER_TF_STEPS teacher-forced steps of the generate's
    first-window tokens (within TOL), and those 224 tokens against the
    CPU's greedy choice at each step (through the same filters; equal where
    the CPU's margin exceeds WHISPER_TIE, the near-ties counted)."""
    from mlx_audio_tpu_torch.models.stt.whisper import Model, ModelDimensions
    from mlx_audio_tpu_torch.models.stt.whisper.audio import log_mel_spectrogram

    t0 = time.perf_counter()
    cpu = cpu_twin(lambda: Model(ModelDimensions(**WHISPER_DIMS), device="cpu"), model)
    pad = 3000 * 160
    with torch.no_grad():
        mel = log_mel_spectrogram(run["clip"], n_mels=128, padding=pad, device="cuda")
        mel_c = log_mel_spectrogram(run["clip"], n_mels=128, padding=pad)
        win = mel[:3000][None]
        feats = model.encoder(win)
        feats_c = cpu.encoder(win.cpu())
    card_tf = _whisper_tf(model, tok, feats, run["tokens"], WHISPER_TF_STEPS)
    cpu_all = _whisper_tf(cpu, tok, feats_c, run["tokens"], WHISPER_SAMPLE_LEN, filtered=True)
    cpu_tf = _whisper_tf(cpu, tok, feats_c, run["tokens"], WHISPER_TF_STEPS)
    ties = _tie_check("whisper greedy tokens", run["tokens"], cpu_all, WHISPER_TIE)
    errs = {"log_mel": float((mel.cpu() - mel_c).abs().max()),
            "encoder": float((feats.cpu() - feats_c).abs().max()),
            "logits": float((card_tf - cpu_tf).abs().max())}
    print(f"whisper card against the CPU ({time.perf_counter() - t0:.1f} s): log-mel "
          f"{tuple(mel.shape)}, encoder output {tuple(feats.shape)} (max |x| "
          f"{float(feats_c.abs().max()):.3f}), {WHISPER_TF_STEPS} teacher-forced steps' "
          f"logits {tuple(card_tf.shape)} (max |logit| {float(cpu_tf.abs().max()):.3f}): "
          f"max abs diff {json.dumps(errs)} (atol {TOL['atol']}, rtol {TOL['rtol']}); "
          f"the generate's first window against the CPU's greedy choice {json.dumps(ties)} "
          f"(a token may differ where its margin is {WHISPER_TIE} or less)", flush=True)
    for name, a, b in (("log-mel", mel.cpu(), mel_c), ("encoder output", feats.cpu(), feats_c),
                       ("teacher-forced logits", card_tf, cpu_tf)):
        if not torch.allclose(a, b, **TOL):
            fail(f"whisper: the {name} on the card differs from the CPU's by "
                 f"{float((a - b).abs().max()):.3e}")
    return {"errors": errs, "tokens": ties}


def whisper_breakdown(model, run: dict) -> dict:
    """Encoder ms a window at batch 1 and 4 (CUDA events); greedy tokens/s
    at batch 1 and 4 and beam steps/s, each decode of 224 tokens from
    precomputed audio features (cross keys and values and the prefill
    included; warm, synced); a profile of 16 decode steps (with their
    prefill) at batch 1."""
    from mlx_audio_tpu_torch.models.stt.whisper import DecodingOptions

    mel4 = run["mel4"]
    out = {}
    with torch.no_grad():
        out["encoder_ms_batch1"] = median_ms(lambda: model.encoder(mel4[:1]), 3)
        out["encoder_ms_batch4"] = median_ms(lambda: model.encoder(mel4), 3)
        out["encoder_ms_per_window_batch4"] = out["encoder_ms_batch4"] / WHISPER_BATCH
        feats = model.encoder(mel4)
        opts = DecodingOptions(language="en")
        g1 = _timed(lambda: model.decode(feats[0], opts))
        g4 = _timed(lambda: model.decode(feats, opts))
        b1 = _timed(lambda: model.decode(feats[0], DecodingOptions(
            language="en", beam_size=WHISPER_BEAM)))
        out.update(tokens_per_s=WHISPER_SAMPLE_LEN / g1,
                   tokens_per_s_batch4=WHISPER_BATCH * WHISPER_SAMPLE_LEN / g4,
                   beam_steps_per_s=WHISPER_SAMPLE_LEN / b1)
        print(f"whisper breakdown (f32): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
              + f"; on {gpu_line()}", flush=True)
        prof = profile_steps("whisper", lambda: model.decode(
            feats[0], DecodingOptions(language="en", sample_len=PROFILE_STEPS)))
    if prof is not None:
        prof.pop("groups")
        prof.pop("device_ms")
        out.update(prof)
    return out


class VoxtralStubTokenizer:
    """``decode``: ids as words (no tokenizer files ship)."""

    def decode(self, ids) -> str:
        return " ".join(f"w{i}" for i in ids)


def build_voxtral():
    """Voxtral-Mini-3B at the published widths with seeded random weights on
    the card: the audio tower and projector f32, the Llama LM and its
    untied head int8 in groups of 64; the head's row of the end-of-speech
    token (2) at 0, so that no decode stops early (its logit 0 is below
    the top of 131 072 random ones); the LM's embedding at ten times the
    init's scale, so that the token fed back, more than the prompt's
    average, sets the next one (at the init's scale a decode settles into a
    cycle of a few tokens)."""
    from mlx_audio_tpu_torch.models.stt.voxtral import Model, ModelConfig
    from mlx_audio_tpu_torch.nn.quantize import quantize_model

    t0 = time.perf_counter()
    model = Model(ModelConfig(text_config=dict(VOXTRAL_TEXT)),
                  tokenizer=VoxtralStubTokenizer(), device="cuda", seed=0)
    with torch.no_grad():
        model.lm_head.weight[VOXTRAL_EOS] = 0
        model.language_model.embed_tokens.weight.mul_(VOXTRAL_EMBED_SCALE)
    quantize_model(model, group_size=64, bits=8,
                   quant_predicate=lambda p, m, c: p.startswith(("language_model", "lm_head")))
    torch.cuda.empty_cache()
    cfg = model.language_model.cfg
    nbytes = {name: sum(t.numel() * t.element_size() for t in m.state_dict().values())
              for name, m in (("audio tower", model.audio_tower),
                              ("projector", model.multi_modal_projector),
                              ("LM", model.language_model), ("head", model.lm_head))}
    print(f"Voxtral-Mini-3B built (LM int8, groups of 64) in {time.perf_counter() - t0:.1f} s: "
          f"hidden {cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads}/{cfg.num_key_value_heads} heads, head_dim "
          f"{cfg.head_dim}, intermediate {cfg.intermediate_size}, vocabulary "
          f"{cfg.vocab_size}, rope theta {cfg.rope_theta:g}; audio {model.audio_cfg.num_mel_bins} "
          f"mels, width {model.audio_cfg.d_model}, {model.audio_cfg.encoder_layers} layers; "
          f"conv1 route {_route_of(model.audio_tower.conv1, 3000)}; state GB: "
          + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in nbytes.items()), flush=True)
    return model


def voxtral_runs(model, launches: dict) -> dict:
    """The entry point: greedy generate of a seeded 30 s clip (one window,
    VOXTRAL_TOKENS tokens) and of a 60 s clip (two windows decoded as one batch through
    _decode_window_rows).  dilated_conv1d must launch once in every encode,
    quantized_matmul 211 times in every decode step (and once for the
    prompt's head); both are held to their plain versions on the path's
    operands."""
    from mlx_audio_tpu_torch.nn import kernels, layers

    clip = _clip(8, VOXTRAL_SECONDS)
    clip2 = _clip(9, 2 * VOXTRAL_SECONDS)
    encodes, counts, wall = {"n": 0}, {}, {}
    path_calls, conv_calls, routes = {}, {}, {}
    undo = _count_calls(model.audio_tower, encodes)
    qmm = record_qmm_calls(path_calls)
    convs = record_conv_calls(conv_calls)
    route_fn = route_recorder(routes)
    run = path_runner(launches, wall)

    def counted(name, fn):
        encodes["n"] = 0
        out = run(name, fn)
        counts[name] = encodes["n"]
        return out

    torch.cuda.reset_peak_memory_stats()
    try:
        one = counted("voxtral_generate", lambda: model.generate(
            clip, max_tokens=VOXTRAL_TOKENS))
        two = counted("voxtral_generate_windows", lambda: model.generate(
            clip2, max_tokens=VOXTRAL_TOKENS))
    finally:
        undo()
        kernels.quantized_matmul = qmm
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
        layers.conv1d_route = route_fn
    peak = torch.cuda.max_memory_allocated() / 1e9
    rows = [s["tokens"] for s in one.segments + two.segments]
    if len(one.segments) != 1 or len(two.segments) != 2 or any(
            len(r) != VOXTRAL_TOKENS for r in rows):
        fail(f"voxtral: windows of {[len(r) for r in rows]} tokens, not 1 and 2 of "
             f"{VOXTRAL_TOKENS}")
    want_qmm = 1 + (VOXTRAL_TOKENS - 1) * VOXTRAL_QMM_PER_STEP
    for name in counts:
        lc = launches[name]
        if counts[name] != 1 or lc["dilated_conv1d"] != 1:
            fail(f"{name}: {lc['dilated_conv1d']} dilated_conv1d launches in "
                 f"{counts[name]} encodes")
        if lc["quantized_matmul"] != want_qmm:
            fail(f"{name}: {lc['quantized_matmul']} quantized_matmul launches, not "
                 f"{want_qmm} (the prompt's head, then {VOXTRAL_QMM_PER_STEP} a step)")
        stray = [k for k in WHISPER_KERNEL_STRAYS if lc[k]]
        if stray:
            fail(f"{name}: kernels off Voxtral's path launched: {stray}")
    print_routes("voxtral", routes)
    path_err = check_qmm_path(path_calls, qmm, "Voxtral")
    conv_err = check_conv_path(conv_calls, convs, "Voxtral")
    rtf = wall["voxtral_generate"] / VOXTRAL_SECONDS
    rtf2 = wall["voxtral_generate_windows"] / (2 * VOXTRAL_SECONDS)
    print(f"voxtral: generate of {VOXTRAL_SECONDS} s: {VOXTRAL_TOKENS} tokens "
          f"({len(set(rows[0]))} distinct), real-time factor {rtf:.4f}; of "
          f"{2 * VOXTRAL_SECONDS} s: 2 windows of {VOXTRAL_TOKENS} tokens "
          f"({[len(set(r)) for r in rows[1:]]} distinct), real-time factor "
          f"{rtf2:.4f}; quantized_matmul "
          f"{VOXTRAL_QMM_PER_STEP} a decode step; peak memory {peak:.2f} GB; wall s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in wall.items()), flush=True)
    return {"wall": wall, "qmm_path_err": path_err, "qmm_path_shapes": len(path_calls),
            "conv_path_err": conv_err, "conv_path_shapes": _per_kernel(conv_calls),
            "clip": clip, "tokens": rows[0], "real_time_factor": rtf,
            "real_time_factor_windows": rtf2, "peak_memory_gb": peak}


def _voxtral_state(model, mel, ids, extra: int):
    """The greedy loop's state after the prompt (as _decode_window_rows
    builds it): caches, pad_len, the spliced embeddings and the prompt's
    last logits."""
    import torch.nn.functional as F

    lm = model.language_model
    dev = model.device
    t = len(ids)
    bucket = max(64, -(-t // 64) * 64)
    padded = F.pad(torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=dev),
                   (bucket - t, 0))[None]
    pad_len = torch.full((1,), bucket - t, dtype=torch.int64, device=dev)
    caches = lm.init_cache(1, max_len=bucket + extra, dtype=model._dtype())
    embeds = model.merge_input_embeddings(padded, mel[None].to(dev))
    h, caches = lm.prefill(caches, embeds, pad_len)
    return caches, pad_len, embeds, model.lm_logits(h[:, -1]).float()


def _voxtral_steps(model, caches, pad_len, tokens):
    """Logits [len(tokens), V] of teacher-forced steps feeding ``tokens``."""
    lm = model.language_model
    out = []
    for t in tokens:
        emb = lm.embed_tokens(torch.tensor([[int(t)]], device=model.device))
        h, caches = lm.step(caches, emb, pad_len)
        out.append(model.lm_logits(h[:, -1]).float())
    return torch.cat(out) if out else torch.zeros(0)


def voxtral_breakdown(model, run: dict) -> dict:
    """The audio tower and projector's ms a window (CUDA events), decode
    tokens/s at batch 1 (the greedy loop's steps after the prompt; warm,
    synced), and a profile of 16 decode steps."""
    from mlx_audio_tpu_torch.nn import kernels

    mel, ids = model._prepare_inputs(run["clip"])
    out = {}
    with torch.no_grad():
        out["audio_embeds_ms"] = median_ms(lambda: model.get_audio_embeds(mel[None]), 3)
        kw = dict(temperature=0.0, top_p=0.95, top_k=0, eos_token_ids=(VOXTRAL_EOS,), seed=0)
        prompt_s = _timed(lambda: model._decode_window_rows(mel[None], ids, max_tokens=1, **kw))
        full_s = _timed(lambda: model._decode_window_rows(
            mel[None], ids, max_tokens=VOXTRAL_TOKENS, **kw))
        out.update(prompt_s=prompt_s, decode_s=full_s - prompt_s,
                   tokens_per_s=(VOXTRAL_TOKENS - 1) / (full_s - prompt_s))
        print(f"voxtral breakdown (int8 LM): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
              + f"; on {gpu_line()}", flush=True)
        caches, pad_len, _, _ = _voxtral_state(model, mel, ids, PROFILE_STEPS + 4)
        toks = run["tokens"][:PROFILE_STEPS + 2]
        _voxtral_steps(model, caches, pad_len, toks[:2])  # warm
        kernels.reset_launches()
        prof = profile_steps("voxtral", lambda: _voxtral_steps(model, caches, pad_len,
                                                               toks[2:]))
    if prof is not None:
        groups, device_ms = prof.pop("groups"), prof.pop("device_ms")
        qmm_ms = groups.get("quantized_matmul (this repo)", (0.0, 0))[0]
        out.update(prof, profile_qmm_share=qmm_ms / device_ms)
        print(f"voxtral profile: quantized_matmul {kernels.LAUNCHES['quantized_matmul']} "
              f"calls, {qmm_ms:.3f} ms, {out['profile_qmm_share']:.2%} of device time",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: Parakeet-TDT-0.6B-v2 and BigVGAN-v2-24kHz-100band
# ---------------------------------------------------------------------------

PARAKEET_VOCAB = 1024  # SentencePiece pieces; the blank follows at 1024
PARAKEET_DURATIONS = [0, 1, 2, 3, 4]
PARAKEET_SECONDS = 60.0  # the generate clip: 3 full 30 s chunks in one batch, the tail alone
PARAKEET_CHUNK = 30.0
PARAKEET_OVERLAP = 15.0
PARAKEET_BATCH = 4  # windows a batched decode
PARAKEET_TF_LABELS = 8  # teacher-forced labels held against the CPU, to TOL
PARAKEET_KERNEL_STRAYS = ("lstm", "dilated_conv1d", "banded_conv1d", "quantized_matmul",
                          "depth_draft")
BIGVGAN_FRAMES = 938  # a 10 s mel at 24 kHz, hop 256
BIGVGAN_SECONDS = BIGVGAN_FRAMES * 256 / 24_000
# launches of each conv kernel a BigVGAN-v2 forward at 938 frames, by
# conv1d_route: 18 + 8 dilated, 10 banded (stages of 768 and 384 channels)
BIGVGAN_ROUTED = {"dilated_conv1d": 26, "banded_conv1d": 10}
BIGVGAN_KERNEL_STRAYS = ("lstm", "quantized_matmul", "depth_draft")
BIGVGAN_POST_SCALE = 100.0  # build_bigvgan's scale of the last conv


def parakeet_config() -> dict:
    """nvidia/parakeet-tdt-0.6b-v2's NeMo config at its published widths:
    the 128-mel frontend, a 24-layer FastConformer (d_model 1024, 8 heads,
    ff 4096, conv kernel 9, relative positions, depthwise-striding
    subsampling by 8 with 256 channels), a 2-layer 640-wide prediction net
    over 1024 pieces and the blank, a 640-wide ReLU joint with 5 TDT
    durations.  Other fields take ConformerArgs's defaults; the pieces are
    stubs ("▁w<id>")."""
    vocab = [f"▁w{i}" for i in range(PARAKEET_VOCAB)]
    return {
        "target": "nemo.collections.asr.models.rnnt_bpe_models.EncDecRNNTBPEModel",
        "model_defaults": {"tdt_durations": PARAKEET_DURATIONS},
        "preprocessor": {"sample_rate": 16000, "normalize": "per_feature",
                         "window_size": 0.025, "window_stride": 0.01, "window": "hann",
                         "features": 128, "n_fft": 512, "dither": 0.0},
        "encoder": {"feat_in": 128, "n_layers": 24, "d_model": 1024, "n_heads": 8,
                    "ff_expansion_factor": 4, "subsampling_factor": 8,
                    "self_attention_model": "rel_pos", "subsampling": "dw_striding",
                    "conv_kernel_size": 9, "subsampling_conv_channels": 256,
                    "pos_emb_max_len": 5000},
        "decoder": {"blank_as_pad": True, "vocab_size": PARAKEET_VOCAB,
                    "prednet": {"pred_hidden": 640, "pred_rnn_layers": 2}},
        "joint": {"num_classes": PARAKEET_VOCAB, "vocabulary": vocab,
                  "jointnet": {"joint_hidden": 640, "activation": "relu",
                               "encoder_hidden": 1024, "pred_hidden": 640},
                  "num_extra_outputs": len(PARAKEET_DURATIONS)},
        "decoding": {"model_type": "tdt", "durations": PARAKEET_DURATIONS},
    }


def bigvgan_config() -> dict:
    """nvidia/bigvgan_v2_24khz_100band_256x's config.json (its model fields)."""
    return dict(num_mels=100, upsample_rates=[4, 4, 2, 2, 2, 2],
                upsample_kernel_sizes=[8, 8, 4, 4, 4, 4], upsample_initial_channel=1536,
                resblock="1", resblock_kernel_sizes=[3, 7, 11],
                resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
                activation="snakebeta", snake_logscale=True, use_tanh_at_final=False,
                use_bias_at_final=False)


def build_parakeet():
    """Parakeet-TDT-0.6B-v2 with seeded random weights on the card, f32,
    and a CTC head on the same encoder widths and weights.  The joint's row
    of the blank is 0, so the blank's logit is 0 while the largest of the
    1024 labels' random logits is above it: every label-loop step emits a
    label, and every chunk emits labels.  (At random weights the encoder's
    output barely changes from frame to frame, and a few labels win every
    step.)"""
    from mlx_audio_tpu_torch.models.stt.parakeet import Model, ParakeetCTC
    from mlx_audio_tpu_torch.models.stt.parakeet.ctc import ConvASRDecoderArgs

    t0 = time.perf_counter()
    cfg = parakeet_config()
    model = Model(cfg, device="cuda", seed=0)
    with torch.no_grad():
        model.joint.joint.weight[PARAKEET_VOCAB] = 0
        model.joint.joint.bias[PARAKEET_VOCAB] = 0
    ctc = ParakeetCTC(model.preprocessor_config, model.encoder_config,
                      ConvASRDecoderArgs(feat_in=model.encoder_config.d_model, num_classes=-1,
                                         vocabulary=model.vocabulary),
                      device="cuda", seed=1)
    ctc.encoder = model.encoder
    torch.cuda.empty_cache()
    nbytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    shown = {k: v for k, v in cfg.items() if k != "joint"}
    shown["joint"] = {k: v for k, v in cfg["joint"].items() if k != "vocabulary"}
    print(f"Parakeet-TDT-0.6B-v2 built (f32, {nbytes / 1e9:.3f} GB, with a CTC head "
          f"sharing its encoder) in {time.perf_counter() - t0:.1f} s; config "
          f"{json.dumps(shown)}; encoder {model.encoder_config}; max_symbols "
          f"{model.max_symbols}", flush=True)
    return model, ctc


def _record_loops(stats: list):
    """Route parakeet's transducer_greedy_loop through a recorder appending
    (rows, steps, labels emitted) of each call to stats; returns the undo."""
    from mlx_audio_tpu_torch.models.stt.parakeet import parakeet as pk

    loop = pk.transducer_greedy_loop

    def recording(model, features, *a, **k):
        out = loop(model, features, *a, **k)
        stats.append((features.shape[0], out[4], int(out[3].sum())))
        return out

    pk.transducer_greedy_loop = recording
    return lambda: setattr(pk, "transducer_greedy_loop", loop)


def _labels(result) -> list:
    return [(t.id, t.start, t.duration) for s in result.sentences for t in s.tokens]


def parakeet_runs(model, ctc, launches: dict) -> dict:
    """The entry points: generate of a seeded 60 s clip read from a wav file
    the phase writes with the port's save_audio (30 s chunks with 15 s of
    overlap: three full chunks in one batched encoder pass and label loop,
    the 15 s tail alone; timed after one untimed generate), decode of one 30 s window at batch 1 and of 4
    windows, and the CTC head's decode of one window.  None of this
    repository's kernels may launch (the convs are pointwise and
    depthwise; the prediction net steps by matmuls)."""
    from mlx_audio_tpu_torch.models.stt.parakeet.audio import log_mel_spectrogram
    from mlx_audio_tpu_torch.nn import layers
    from mlx_audio_tpu_torch.utils.audio_io import load_audio, save_audio

    pre = model.preprocessor_config
    wall, routes, loops = {}, {}, []
    run = path_runner(launches, wall)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "clip.wav")
        save_audio(path, _clip(10, PARAKEET_SECONDS), pre.sample_rate)
        clip = load_audio(path, pre.sample_rate)
        windows = _clip(11, PARAKEET_CHUNK * PARAKEET_BATCH)
        n = int(PARAKEET_CHUNK * pre.sample_rate)
        mel4 = torch.cat([log_mel_spectrogram(windows[i * n:(i + 1) * n], pre, device="cuda")
                          for i in range(PARAKEET_BATCH)])
        # warm: the timed generate is not the path's first call
        model.generate(path, chunk_duration=PARAKEET_CHUNK, overlap_duration=PARAKEET_OVERLAP)
        undo = _record_loops(loops)
        route_fn = route_recorder(routes)
        torch.cuda.reset_peak_memory_stats()
        try:
            out = run("parakeet_generate", lambda: model.generate(
                path, chunk_duration=PARAKEET_CHUNK, overlap_duration=PARAKEET_OVERLAP))
            one = run("parakeet_decode", lambda: model.decode(mel4[:1]))
            four = run("parakeet_decode_batch", lambda: model.decode(mel4))
            ctc_one = run("parakeet_ctc_decode", lambda: ctc.decode(mel4[:1]))
        finally:
            undo()
            layers.conv1d_route = route_fn
    peak = torch.cuda.max_memory_allocated() / 1e9
    if [b for b, _, _ in loops] != [3, 1, 1, PARAKEET_BATCH]:
        fail(f"parakeet: label loops of {[b for b, _, _ in loops]} rows, not 3 full chunks "
             f"and the tail, then 1 and {PARAKEET_BATCH} windows")
    if any(labels < rows for rows, _, labels in loops):
        fail(f"parakeet: a chunk emitted no labels: (rows, steps, labels) {loops}")
    if _labels(four[0]) != _labels(one[0]):
        fail("parakeet: window 0 of the batch of 4 decodes other labels than alone")
    words = len(_labels(out))
    for name in ("parakeet_generate", "parakeet_decode", "parakeet_decode_batch",
                 "parakeet_ctc_decode"):
        stray = [k for k in PARAKEET_KERNEL_STRAYS if launches[name][k]]
        if stray:
            fail(f"{name}: kernels launched on Parakeet's path, which takes none: {stray}")
    if any(r != "library" for r, *_ in routes):
        fail(f"parakeet: a conv took a kernel's route: {sorted(routes)}")
    print_routes("parakeet", routes)
    rtf = wall["parakeet_generate"] / PARAKEET_SECONDS
    print(f"parakeet: generate of {PARAKEET_SECONDS} s from a wav file ({len(clip)} samples): "
          f"{words} labels after the merges ({len({t for t, _, _ in _labels(out)})} "
          f"distinct), text {out.text[:60]!r}...; label loops "
          f"(rows, steps, labels) {loops}; decode of one window {len(_labels(one[0]))} "
          f"labels, of {PARAKEET_BATCH} {[len(_labels(r)) for r in four]}; CTC decode "
          f"{len(_labels(ctc_one[0]))} labels; real-time factor {rtf:.4f} (generate's wall "
          f"time over the audio's length); peak memory {peak:.2f} GB; wall s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in wall.items()) + f"; on {gpu_line()}",
          flush=True)
    return {"wall": wall, "mel4": mel4, "labels": _labels(one[0]), "loops": loops,
            "real_time_factor": rtf, "peak_memory_gb": peak}


def _parakeet_tf(model, feats, labels, scale: float, n=None):
    """Teacher-forced joint logits [n, classes] (on the CPU) of one row:
    label i's step at the frame of its start time, the prediction net fed
    the labels before it (every step of the phase's loop emits)."""
    dev = feats.device
    state = model.decoder.init_state(1, feats.dtype, dev)
    last, out = PARAKEET_VOCAB, []  # the blank start feeds the zero vector
    with torch.no_grad():
        for tok, start, _ in labels[:n]:
            frame = int(round(start / scale))
            dec, state2 = model.decoder.step(torch.tensor([last], device=dev), state,
                                             torch.tensor([last != PARAKEET_VOCAB], device=dev))
            out.append(model.joint(feats[:, frame], dec).float().cpu())
            last, state = tok, state2
    return torch.cat(out)


def parakeet_card_against_cpu(model, ctc, run: dict) -> dict:
    """Through the same weights on the card and the CPU, on the first 30 s
    window: the log-mel, the encoder output, the joint's logits over
    PARAKEET_TF_LABELS teacher-forced labels and the CTC log-probs (within
    TOL); then every label of the card's decode of that window against the
    CPU's choice at its step, label and duration (equal where the CPU's
    winner beats its runner-up by more than WHISPER_TIE)."""
    from mlx_audio_tpu_torch.models.stt.parakeet import Model
    from mlx_audio_tpu_torch.models.stt.parakeet.audio import log_mel_spectrogram

    t0 = time.perf_counter()
    cpu = cpu_twin(lambda: Model(parakeet_config(), device="cpu"), model)
    w_ctc = ctc.decoder.decoder_layers[0]
    pre = model.preprocessor_config
    audio = _clip(11, PARAKEET_CHUNK)
    scale = model._time_scale()
    labels = run["labels"]
    with torch.no_grad():
        mel = log_mel_spectrogram(audio, pre, device="cuda")
        mel_c = log_mel_spectrogram(audio, pre)
        feats, _ = model.encoder(mel)
        feats_c, _ = cpu.encoder(mel.cpu())
        logp = ctc.decoder(feats).cpu()
        logp_c = torch.log_softmax(torch.nn.functional.conv1d(
            feats_c.transpose(1, 2), w_ctc.weight.cpu(), w_ctc.bias.cpu()).transpose(1, 2), -1)
    card_tf = _parakeet_tf(model, feats, labels, scale, PARAKEET_TF_LABELS)
    cpu_all = _parakeet_tf(cpu, feats_c, labels, scale)
    v = PARAKEET_VOCAB
    tok_ties = _tie_check("parakeet labels", [t for t, _, _ in labels], cpu_all[:, :v + 1],
                          WHISPER_TIE)
    durs = [PARAKEET_DURATIONS.index(int(round(d / scale))) for _, _, d in labels]
    dur_ties = _tie_check("parakeet durations", durs, cpu_all[:, v + 1:], WHISPER_TIE)
    errs = {"log_mel": float((mel.cpu() - mel_c).abs().max()),
            "encoder": float((feats.cpu() - feats_c).abs().max()),
            "joint_logits": float((card_tf - cpu_all[:PARAKEET_TF_LABELS]).abs().max()),
            "ctc_log_probs": float((logp - logp_c).abs().max())}
    print(f"parakeet card against the CPU ({time.perf_counter() - t0:.1f} s): log-mel "
          f"{tuple(mel.shape)}, encoder output {tuple(feats.shape)} (max |x| "
          f"{float(feats_c.abs().max()):.3f}), joint logits of {PARAKEET_TF_LABELS} "
          f"teacher-forced labels (max |logit| {float(cpu_all.abs().max()):.3f}), CTC "
          f"log-probs {tuple(logp.shape)}: max abs diff {json.dumps(errs)} (atol "
          f"{TOL['atol']}, rtol {TOL['rtol']}); the window's {len(labels)} labels against "
          f"the CPU's choice {json.dumps(tok_ties)}, their durations {json.dumps(dur_ties)}",
          flush=True)
    for name, a, b in (("log-mel", mel.cpu(), mel_c), ("encoder output", feats.cpu(), feats_c),
                       ("joint logits", card_tf, cpu_all[:PARAKEET_TF_LABELS]),
                       ("CTC log-probs", logp, logp_c)):
        if not torch.allclose(a, b, **TOL):
            fail(f"parakeet: the {name} on the card differ from the CPU's by "
                 f"{float((a - b).abs().max()):.3e}")
    del cpu
    return {"errors": errs, "labels": tok_ties, "durations": dur_ties}


def parakeet_breakdown(model, run: dict) -> dict:
    """Encoder ms a 30 s window at batch 1 and 4 (CUDA events); the label
    loop's steps/s at batch 1 from precomputed encoder features (warm,
    synced); a profile of one decode of a window."""
    from mlx_audio_tpu_torch.models.stt.parakeet import transducer_greedy_loop

    mel4 = run["mel4"]
    out = {}
    with torch.no_grad():
        out["encoder_ms_batch1"] = median_ms(lambda: model.encoder(mel4[:1]), 3)
        out["encoder_ms_batch4"] = median_ms(lambda: model.encoder(mel4), 3)
        feats, lengths = model.encoder(mel4[:1])
        kw = dict(vocab_size=PARAKEET_VOCAB, max_symbols=int(model.max_symbols),
                  max_out=(int(model.max_symbols) + 1) * int(lengths.max()), tdt=True)
        steps = {}

        def loop():
            steps["n"] = transducer_greedy_loop(model, feats, lengths, PARAKEET_DURATIONS,
                                                **kw)[4]

        loop_s = _timed(loop)
        out.update(loop_steps=steps["n"], loop_s=loop_s, loop_steps_per_s=steps["n"] / loop_s)
        print(f"parakeet breakdown (f32): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in out.items())
            + f"; on {gpu_line()}", flush=True)
        prof = profile_steps("parakeet decode of one window", lambda: model.decode(mel4[:1]),
                             1, KERNEL_GROUPS)
    if prof is not None:
        del prof["groups"], prof["device_ms"]
        out.update(prof)
    return out


def build_bigvgan():
    """BigVGAN-v2-24kHz-100band at the published config with seeded random
    weights on the card, f32; conv_post's weight_g at BIGVGAN_POST_SCALE
    times the init's (the audio is otherwise about 5e-3 at most, under the
    tolerance it is held to)."""
    from mlx_audio_tpu_torch.codec.bigvgan import BigVGAN

    t0 = time.perf_counter()
    model = BigVGAN(bigvgan_config(), device="cuda", seed=0)
    with torch.no_grad():
        model.conv_post.weight_g.mul_(BIGVGAN_POST_SCALE)
    nbytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    print(f"BigVGAN-v2-24kHz-100band built (f32, {nbytes / 1e9:.3f} GB) in "
          f"{time.perf_counter() - t0:.1f} s; config {json.dumps(bigvgan_config())} "
          f"(use_tanh_at_final {model.config.use_tanh_at_final}, use_bias_at_final "
          f"{model.config.use_bias_at_final})", flush=True)
    return model


def bigvgan_runs(model, launches: dict) -> dict:
    """Forwards of a seeded 10 s mel (938 frames) at batch 1 and 2: each must
    launch dilated_conv1d 26 times and banded_conv1d 10 times (the route
    recorder confirms the routes) and no other kernel; each launched conv
    is held to its plain version on the path's own operands; the audio is
    finite, in [-1, 1], and row 0 of the batch equals the batch-1 run."""
    from mlx_audio_tpu_torch.nn import kernels, layers

    mel = torch.as_tensor(np.random.default_rng(12).standard_normal(
        (2, 100, BIGVGAN_FRAMES)), dtype=torch.float32)
    wall, routes, conv_calls = {}, {}, {}
    run = path_runner(launches, wall)
    convs = record_conv_calls(conv_calls)
    route_fn = route_recorder(routes)
    torch.cuda.reset_peak_memory_stats()
    try:
        one = run("bigvgan_forward", lambda: model(mel[:1]))
        two = run("bigvgan_forward_batch2", lambda: model(mel))
    finally:
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
        layers.conv1d_route = route_fn
    peak = torch.cuda.max_memory_allocated() / 1e9
    samples = BIGVGAN_FRAMES * int(np.prod(model.config.upsample_rates))
    for y, b in ((one, 1), (two, 2)):
        if y.shape != (b, samples, 1) or not bool(torch.isfinite(y).all()) or float(
                y.abs().max()) > 1.0:
            fail(f"bigvgan: audio {tuple(y.shape)}, max |y| {float(y.abs().max())}")
    row_err = float((two[:1] - one).abs().max())
    if not torch.allclose(two[:1], one, **TOL):
        fail(f"bigvgan: row 0 of the batch of 2 differs from the batch-1 run by {row_err:.3e}")
    for name in ("bigvgan_forward", "bigvgan_forward_batch2"):
        lc = launches[name]
        got = {k: lc[k] for k in BIGVGAN_ROUTED}
        if got != BIGVGAN_ROUTED:
            fail(f"{name}: conv kernel launches {got}, not {BIGVGAN_ROUTED}")
        stray = [k for k in BIGVGAN_KERNEL_STRAYS if lc[k]]
        if stray:
            fail(f"{name}: kernels off BigVGAN's path launched: {stray}")
    print_routes("bigvgan", routes)
    conv_err = check_conv_path(conv_calls, convs, "BigVGAN")
    print(f"bigvgan: forward of {BIGVGAN_FRAMES} mel frames ({BIGVGAN_SECONDS:.4f} s of "
          f"24 kHz audio) at batch 1 and 2: audio {tuple(two.shape)}, max |y| "
          f"{float(two.abs().max()):.4f}, row 0 against batch 1 {row_err:.3e}; peak memory "
          f"{peak:.2f} GB; wall s: " + ", ".join(f"{k} {v:.4f}" for k, v in wall.items())
          + f"; on {gpu_line()}", flush=True)
    return {"wall": wall, "mel": mel, "audio": one, "conv_path_err": conv_err,
            "conv_path_shapes": _per_kernel(conv_calls), "peak_memory_gb": peak}


def vocoder_profile(label: str, call) -> dict:
    """profile_steps of one ``call`` (a vocoder forward).  Where the trace
    holds fewer dilated_conv1d events than the wrapper counted launches, a
    profile of two calls in one window tells a loss at the window's start
    (one event short of 2n) from one in every call (two short).  Returns
    the one call's profile figures and ``dilated_events`` {calls: [in the
    trace, counted]}; {} where no device time was recorded."""
    from mlx_audio_tpu_torch.nn import kernels

    out, events = {}, {}
    for calls in (1, 2):
        before = kernels.LAUNCHES["dilated_conv1d"]
        prof = profile_steps(f"{label}, {calls} call{'s' * (calls > 1)}",
                             lambda: [call() for _ in range(calls)], 1, KERNEL_GROUPS)
        if prof is None:
            break
        traced = prof["groups"].get("dilated_conv1d (this repo)", (0.0, 0))[1]
        events[calls] = [traced, kernels.LAUNCHES["dilated_conv1d"] - before]
        if calls == 1:
            del prof["groups"], prof["device_ms"]
            out.update(prof)
            if traced >= events[1][1]:
                break
    if events:
        out["dilated_events"] = events
        print(f"{label} profile: dilated_conv1d events in the trace against launches "
              "counted: " + "; ".join(f"{k} call{'s' * (k > 1)} {t} of {c}"
                                      for k, (t, c) in events.items()), flush=True)
    return out


def bigvgan_breakdown(model, run: dict) -> dict:
    """ms a forward at batch 1 and 2 (CUDA events), the real-time factor, a
    profile of one batch-1 forward (``vocoder_profile``)."""
    mel = run["mel"].cuda()
    out = {}
    with torch.no_grad():
        out["forward_ms_batch1"] = median_ms(lambda: model(mel[:1]), 3)
        out["forward_ms_batch2"] = median_ms(lambda: model(mel), 3)
        out["real_time_factor"] = out["forward_ms_batch1"] / 1e3 / BIGVGAN_SECONDS
        print(f"bigvgan breakdown (f32): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
              + f"; on {gpu_line()}", flush=True)
        out.update(vocoder_profile("bigvgan forward (batch 1)", lambda: model(mel[:1])))
    return out


def bigvgan_card_against_cpu(model, run: dict) -> float:
    """The batch-1 forward through the same weights on the CPU (the conv
    kernels' plain versions and the library's convs): audio within TOL."""
    from mlx_audio_tpu_torch.codec.bigvgan import BigVGAN

    t0 = time.perf_counter()
    cpu = cpu_twin(lambda: BigVGAN(bigvgan_config(), device="cpu"), model)
    ref = cpu(run["mel"][:1])
    err = float((run["audio"].cpu() - ref).abs().max())
    print(f"bigvgan card against the CPU ({time.perf_counter() - t0:.1f} s): audio "
          f"{tuple(ref.shape)} (max |y| {float(ref.abs().max()):.4f}): max abs diff "
          f"{err:.3e} (atol {TOL['atol']}, rtol {TOL['rtol']})", flush=True)
    if not torch.allclose(run["audio"].cpu(), ref, **TOL):
        fail(f"bigvgan: the audio on the card differs from the CPU's by {err:.3e}")
    return err


# ---------------------------------------------------------------------------
# phase 12: IndexTTS-1.5
# ---------------------------------------------------------------------------

INDEXTTS_TOKENS = 255  # mel codes a run past the first: 256 latents
INDEXTTS_TIMED_STEPS = 64  # decode steps a timed decode of the breakdown
INDEXTTS_SECONDS = (INDEXTTS_TOKENS + 1) * 1024 / 24_000  # 10.92 s of 24 kHz audio
INDEXTTS_REF_SECONDS = 3.0  # the reference clip
INDEXTTS_TEXT = ORPHEUS_TEXT
# four prompts of different lengths; the last crosses into the next 64-slot
# bucket, so the other rows sit behind more left padding than in their
# single runs
INDEXTTS_BATCH_TEXTS = [
    INDEXTTS_TEXT, "One short line.", "A second line, a little longer than the first.",
    "And the fourth line of the batch is the longest of the four, so long that its "
    "prompt needs one more bucket."]
# the batch rows held to single runs: the greedy run's text, and the
# shortest, behind the most left padding
INDEXTTS_SINGLE_ROWS = (0, 1)
INDEXTTS_SAMPLED = {"temperature": 0.8, "top_k": 30, "seed": 7}
INDEXTTS_TIE = 1e-5  # a code may differ from the CPU's where its margin is this or less
# latents the vocoder check runs on the CPU: at the last upsampling stage
# 6 144 rows at 384 channels, past the banded route's 4 096 as the whole
# run's are
INDEXTTS_CPU_LATENTS = 96
INDEXTTS_AUDIO_STD = 0.05  # build_indextts scales the last conv to this audio std
# launches of each conv kernel a vocoder call at 256 latents, by conv1d_route:
# 18 + 8 dilated, 10 banded (the stages of 768 and 384 channels; the
# 768-channel stage takes dilated_conv1d from 256 latents, 2048 rows)
INDEXTTS_ROUTED = {"dilated_conv1d": 26, "banded_conv1d": 10}


def indextts_config() -> dict:
    """IndexTTS-1.5-class widths (scripts/bench_indextts.py): a 1280 x 24
    GPT-2 with 20 heads over 8 194 mel codes and 12 001 text rows; a 512 x 6
    conformer with 8 heads and conv2d2 subsampling, a perceiver of 32
    latents; the conditioned BigVGAN from 1536 channels, 8 x 8 x 4 x 2 x 2
    upsampling, K 3/7/11 at d 1/3/5, a 512-wide speaker embedding from 100
    mels."""
    conformer = {"input_size": 100, "output_size": 512, "num_blocks": 6,
                 "linear_units": 2048, "attention_heads": 8, "input_layer": "conv2d2",
                 "cnn_module_kernel": 15, "pos_emb_max_len": 5000, "perceiver_mult": 4}
    return {
        "bigvgan": {"num_mels": 100, "upsample_rates": [8, 8, 4, 2, 2],
                    "upsample_kernel_sizes": [16, 16, 8, 4, 4],
                    "upsample_initial_channel": 1536, "resblock": "1",
                    "resblock_kernel_sizes": [3, 7, 11],
                    "resblock_dilation_sizes": [[1, 3, 5]] * 3, "activation": "snakebeta",
                    "snake_logscale": True, "use_tanh_at_final": False, "gpt_dim": 1280,
                    "speaker_embedding_dim": 512},
        "gpt": {"model_dim": 1280, "heads": 20, "layers": 24, "max_mel_tokens": 605,
                "max_text_tokens": 402, "number_text_tokens": 12000,
                "number_mel_codes": 8194, "start_mel_token": 8192, "stop_mel_token": 8193,
                "start_text_token": 0, "stop_text_token": 1,
                "condition_module": conformer, "condition_num_latent": 32},
        "sample_rate": 24000,
    }


class IndexTTSStubTokenizer:
    """One id a character, in [2, 12 000) (0 and 1 are start_text and
    stop_text): no SentencePiece model ships."""

    def encode(self, text):
        return [2 + (ord(c) * 7919) % 11998 for c in text]


def _indextts_clip() -> np.ndarray:
    rng = np.random.default_rng(17)
    return (rng.standard_normal(int(INDEXTTS_REF_SECONDS * 24_000)) * 0.1).astype(np.float32)


def build_indextts():
    """IndexTTS at indextts_config() with seeded random weights on the card,
    f32.  The mel head's stop row is 0 (weight and bias): its logit stays
    below the winners', so every run makes its whole budget.  The
    vocoder's last conv is scaled so that the audio's std on a seeded latent
    stream is INDEXTTS_AUDIO_STD (at the init it is far smaller)."""
    from mlx_audio_tpu_torch.models.tts.indextts import Model
    from mlx_audio_tpu_torch.models.tts.indextts.vocoder import log_mel_spectrogram

    t0 = time.perf_counter()
    model = Model(indextts_config(), tokenizer=IndexTTSStubTokenizer(), device="cuda", seed=0)
    stop = model.args.gpt.stop_mel_token
    with torch.no_grad():
        model.mel_head.weight[stop] = 0.0
        model.mel_head.bias[stop] = 0.0
        gen = torch.Generator(device="cuda").manual_seed(3)
        lat = torch.randn(1, 64, 1280, generator=gen, device="cuda")
        mel = log_mel_spectrogram(torch.as_tensor(_indextts_clip(), device="cuda"))
        std = float(model.bigvgan(lat, mel).std())
        model.bigvgan.conv_post.weight_g.mul_(INDEXTTS_AUDIO_STD / std)
    params = sum(t.numel() for t in model.parameters())
    print(f"IndexTTS built (f32, {params / 1e6:.1f} M parameters, {4 * params / 1e9:.3f} GB) "
          f"in {time.perf_counter() - t0:.1f} s; the vocoder's last conv scaled by "
          f"{INDEXTTS_AUDIO_STD / std:.2f}; config {json.dumps(indextts_config())}", flush=True)
    return model


def _check_indextts(name: str, result, hop: int) -> None:
    samples = (INDEXTTS_TOKENS + 1) * hop
    a = np.asarray(result.audio)
    if result.token_count != INDEXTTS_TOKENS + 1 or a.shape != (samples,) or \
            not np.isfinite(a).all() or np.abs(a).max() > 1.0:
        fail(f"{name}: {result.token_count} latents, audio {a.shape}, max |y| "
             f"{np.abs(a).max():.4f}")


def indextts_runs(model, launches: dict) -> dict:
    """Greedy generate of one text, generate_batch of 4 texts and the single
    runs of rows INDEXTTS_SINGLE_ROWS (row 0's is the greedy run), a
    sampled generate twice with one seed, all from a seeded
    3 s clip as ref_audio, INDEXTTS_TOKENS codes each.  Every vocoder call
    must launch dilated_conv1d 26 times and banded_conv1d 10 times and no
    other kernel of ours launch; each launched conv is held to its plain
    version on the path's own operands; those batch rows' codes equal their
    single runs' and their audio within TOL; the sampled runs repeat."""
    from mlx_audio_tpu_torch.nn import kernels, layers

    clip = _indextts_clip()
    budget = {"ref_audio": clip, "max_tokens": INDEXTTS_TOKENS}
    wall, routes, conv_calls, calls, rec, per_run = {}, {}, {}, [], [], {}
    run = path_runner(launches, wall)

    def counted(name, fn):
        n_calls, n_rec = len(calls), len(rec)
        out = run(name, fn)
        per_run[name] = (calls[n_calls:], rec[n_rec:])
        return out

    latents_fn = model.generate_latents

    def recording(*a, **k):
        rec.append(latents_fn(*a, **k))
        return rec[-1]

    model.generate_latents = recording
    hook = model.bigvgan.register_forward_pre_hook(lambda m, a: calls.append(a[0].shape[0]))
    convs = record_conv_calls(conv_calls)
    route_fn = route_recorder(routes)
    torch.cuda.reset_peak_memory_stats()
    try:
        greedy = counted("indextts_generate", lambda: list(model.generate(
            INDEXTTS_TEXT, temperature=0, **budget))[0])
        batch = counted("indextts_generate_batch", lambda: model.generate_batch(
            INDEXTTS_BATCH_TEXTS, temperature=0, **budget))
        singles = [greedy] + [
            counted(f"indextts_single_{i}", lambda i=i: model.generate_batch(
                [INDEXTTS_BATCH_TEXTS[i]], temperature=0, **budget)[0])
            for i in INDEXTTS_SINGLE_ROWS[1:]]
        sampled = [counted(f"indextts_sampled_{i}", lambda: list(model.generate(
            INDEXTTS_TEXT, **INDEXTTS_SAMPLED, **budget))[0]) for i in range(2)]
    finally:
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
        layers.conv1d_route = route_fn
        hook.remove()
        del model.generate_latents
    peak = torch.cuda.max_memory_allocated() / 1e9
    hop = int(np.prod(model.args.bigvgan.upsample_rates))
    for name, r in [("generate", greedy), *[(f"batch row {i}", r) for i, r in enumerate(batch)],
                    *[(f"single {i}", r) for i, r in enumerate(singles)],
                    *[(f"sampled {i}", r) for i, r in enumerate(sampled)]]:
        _check_indextts(f"indextts {name}", r, hop)
    for name, (sizes, _) in per_run.items():
        want_sizes = [4] if name == "indextts_generate_batch" else [1]
        if sizes != want_sizes:
            fail(f"{name}: vocoder calls of {sizes} rows, not {want_sizes}")
        lc = launches[name]
        got = {k: lc[k] for k in INDEXTTS_ROUTED}
        if got != INDEXTTS_ROUTED:
            fail(f"{name}: conv kernel launches {got}, not {INDEXTTS_ROUTED} a vocoder call")
        stray = [k for k in lc if k not in INDEXTTS_ROUTED and lc[k]]
        if stray:
            fail(f"{name}: kernels off IndexTTS's path launched: {stray}")

    def codes(name):  # the run's codes, by row
        return per_run[name][1][0][1]

    batch_codes = codes("indextts_generate_batch")
    single_codes = [codes("indextts_generate")[0]] + [
        codes(f"indextts_single_{i}")[0] for i in INDEXTTS_SINGLE_ROWS[1:]]
    stop = model.args.gpt.stop_mel_token
    if any(stop in c for c in batch_codes + single_codes):
        fail("indextts: a run sampled the stop code")
    row_err = []
    for i, s, s_codes in zip(INDEXTTS_SINGLE_ROWS, singles, single_codes):
        r = batch[i]
        if batch_codes[i] != s_codes:
            k = next(j for j, (a, b) in enumerate(zip(batch_codes[i], s_codes)) if a != b)
            fail(f"indextts: batch row {i}'s code {k} is {batch_codes[i][k]}, its single "
                 f"run's {s_codes[k]}")
        row_err.append(float(np.abs(r.audio - s.audio).max()))
        if not np.allclose(r.audio, s.audio, **TOL):
            fail(f"indextts: batch row {i}'s audio differs from its single run by "
                 f"{row_err[-1]:.3e}")
    sampled_codes = [codes(f"indextts_sampled_{i}")[0] for i in range(2)]
    sampled_err = float(np.abs(sampled[0].audio - sampled[1].audio).max())
    if sampled_codes[0] != sampled_codes[1] or not np.allclose(
            sampled[0].audio, sampled[1].audio, **TOL):
        fail(f"indextts: the sampled run does not repeat (audio {sampled_err:.3e})")
    if sampled_codes[0] == single_codes[0]:
        fail("indextts: the sampled run's codes equal the greedy run's")
    print_routes("indextts", routes)
    conv_err = check_conv_path(conv_calls, convs, "IndexTTS")
    print(f"indextts: generate, generate_batch of {len(INDEXTTS_BATCH_TEXTS)} (prompts of "
          f"{[len(t) for t in INDEXTTS_BATCH_TEXTS]} characters), "
          f"{len(INDEXTTS_SINGLE_ROWS) - 1} more single run and a "
          f"sampled generate twice, {INDEXTTS_TOKENS + 1} latents each ({INDEXTTS_SECONDS:.4f} s "
          f"of 24 kHz audio): batch rows {list(INDEXTTS_SINGLE_ROWS)} against single runs: "
          f"codes equal, audio "
          f"{', '.join(f'{e:.3e}' for e in row_err)}; sampled repeat: codes equal, audio "
          f"{sampled_err:.3e}, {sum(a != b for a, b in zip(sampled_codes[0], single_codes[0]))} "
          f"of {INDEXTTS_TOKENS + 1} codes differ from greedy; max |y| "
          f"{float(np.abs(greedy.audio).max()):.4f}, std {float(greedy.audio.std()):.4f}; peak "
          f"memory {peak:.2f} GB; wall s: " + ", ".join(f"{k} {v:.4f}" for k, v in wall.items())
          + f"; on {gpu_line()}", flush=True)
    greedy_stream = per_run["indextts_generate"][1][0][0][0]
    return {"wall": wall, "clip": clip, "audio": greedy.audio, "stream": greedy_stream,
            "codes": single_codes[0], "conv_path_err": conv_err,
            "conv_path_shapes": _per_kernel(conv_calls), "peak_memory_gb": peak}


def _wall(fn) -> float:
    """Wall seconds of one synced call of ``fn`` (its shapes already run)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _indextts_decode_steps(model, state, n: int):
    """n greedy decode steps through the model's own step from ``state``
    (``Model._start``'s)."""
    caches, pad_len, prompt_len, latent = state
    last = model.mel_head(latent).argmax(-1)
    for s in range(n):
        last = model.mel_head(model._step(caches, last, s, pad_len, prompt_len)).argmax(-1)
    return last


def indextts_breakdown(model, run: dict) -> dict:
    """The log-mel, conditioning and prefill ms (CUDA events), decode steps/s
    of generate_latents of INDEXTTS_TIMED_STEPS at batch 1 and 4 (its wall
    time less the prompt's),
    the vocoder ms a call at batch 1 and 4, generate's real-time factor
    (warm: the runs before it were its untimed calls), then profiles of 32
    decode steps and of one vocoder call (``vocoder_profile``)."""
    from mlx_audio_tpu_torch.models.tts.indextts import indextts as it
    from mlx_audio_tpu_torch.models.tts.indextts.vocoder import log_mel_spectrogram

    n = INDEXTTS_TOKENS
    clip = torch.as_tensor(run["clip"], device="cuda")
    out = {}
    with torch.no_grad():
        mel = log_mel_spectrogram(clip)
        out["log_mel_ms"] = median_ms(lambda: log_mel_spectrogram(clip), 5)
        out["conditioning_ms"] = median_ms(lambda: model.get_conditioning(mel), 5)
        out["speaker_embedding_ms"] = median_ms(
            lambda: model.bigvgan.speaker_encoder(mel), 5)
        row = model.prepare_input_embedding([INDEXTTS_TEXT], mel)
        bucket = it._bucket(row.shape[1])
        padded = torch.zeros(1, bucket, row.shape[2], device="cuda")
        padded[:, bucket - row.shape[1]:] = row
        pad_len = torch.tensor([bucket - row.shape[1]], device="cuda")
        out["prefill_ms"] = median_ms(lambda: model.gpt.prefill_left(
            model.gpt.init_cache(1, bucket + n), padded, pad_len), 5)
        timed = INDEXTTS_TIMED_STEPS
        for b, texts in ((1, [INDEXTTS_TEXT]), (4, INDEXTTS_BATCH_TEXTS)):
            start = _wall(lambda: model._start(texts, mel, timed))
            total = _wall(lambda: model.generate_latents(texts, mel, timed, temperature=0))
            out[f"decode_steps_per_s_batch{b}"] = timed / (total - start)
        stream = run["stream"][None]
        out["vocoder_ms_batch1"] = median_ms(lambda: model.bigvgan(stream, mel), 3)
        out["vocoder_ms_batch4"] = median_ms(
            lambda: model.bigvgan(stream.expand(4, -1, -1), mel), 3)
        out["generate_s"] = _wall(lambda: list(model.generate(
            INDEXTTS_TEXT, ref_audio=run["clip"], max_tokens=n, temperature=0)))
        out["real_time_factor"] = out["generate_s"] / INDEXTTS_SECONDS
        print(f"indextts breakdown (f32, greedy, {n + 1} latents): " + ", ".join(
            f"{k} {v:.4f}" for k, v in out.items()) + f"; on {gpu_line()}", flush=True)
        state = model._start([INDEXTTS_TEXT], mel, PROFILE_STEPS + 2)
        _indextts_decode_steps(model, state, 2)  # warm
        prof = profile_steps("indextts gpt", lambda: _indextts_decode_steps(
            model, state, PROFILE_STEPS))
        if prof is not None:
            del prof["groups"], prof["device_ms"]
            out.update({f"gpt_{k}": v for k, v in prof.items()})
        prof = vocoder_profile("indextts vocoder (batch 1)", lambda: model.bigvgan(stream, mel))
        out.update({f"vocoder_{k}": v for k, v in prof.items()})
    return out


def indextts_card_against_cpu(model, run: dict) -> dict:
    """The same weights on the CPU: the clip's log-mel, the conditioning
    latents and the speaker embedding (each from its own log-mel), the
    latents and logits of the greedy run's prompt and all its steps
    teacher-forced in one causal pass (its codes fed back), the card's
    codes against the CPU's argmax (equal where the margin exceeds
    INDEXTTS_TIE), and the vocoder's audio on the first
    INDEXTTS_CPU_LATENTS of the card's latents and the log-mel, on both."""
    from mlx_audio_tpu_torch.models.tts.indextts import Model
    from mlx_audio_tpu_torch.models.tts.indextts.vocoder import log_mel_spectrogram

    t0 = time.perf_counter()
    cpu = cpu_twin(lambda: Model(indextts_config(), tokenizer=IndexTTSStubTokenizer(),
                                 device="cpu"), model)
    out, errs = {}, {}

    def hold(name, card, ref):
        card = card.cpu()
        errs[name] = float((card - ref).abs().max())
        if not torch.allclose(card, ref, **TOL):
            fail(f"indextts: the card's {name} differs from the CPU's by {errs[name]:.3e}")

    with torch.no_grad():
        clip = torch.as_tensor(run["clip"])
        mel_card, mel_cpu = log_mel_spectrogram(clip.cuda()), log_mel_spectrogram(clip)
        hold("log-mel", mel_card, mel_cpu)
        hold("conditioning latents", model.get_conditioning(mel_card),
             cpu.get_conditioning(mel_cpu))
        hold("speaker embedding", model.bigvgan.speaker_encoder(mel_card),
             cpu.bigvgan.speaker_encoder(mel_cpu))
        g = cpu.args.gpt
        prompt = cpu.prepare_input_embedding([INDEXTTS_TEXT], mel_cpu)  # [1, L, D]
        n_prompt = prompt.shape[1]
        codes = torch.tensor(run["codes"][:-1])
        pos = torch.clamp(n_prompt + torch.arange(len(codes)),
                          max=cpu.mel_pos_embedding.emb.weight.shape[0] - 1)
        steps = cpu.mel_embedding(codes) + cpu.mel_pos_embedding.emb(pos)
        x = torch.cat([prompt, steps[None]], dim=1)
        i = torch.arange(x.shape[1])
        mask = torch.where(i[None, :] <= i[:, None], 0.0, -1e9)
        hidden = cpu.gpt._run(cpu.gpt.init_cache(1, x.shape[1]), x, mask)
        latents = cpu.final_norm(hidden[0, n_prompt - 1:])  # [301, D]
        logits = cpu.mel_head(latents)
        hold("latents (teacher-forced)", run["stream"], latents)
        hold("logits (teacher-forced)", model.mel_head(run["stream"]), logits)
        out["codes"] = _tie_check("indextts", run["codes"], logits, INDEXTTS_TIE)
        # the vocoder on the first INDEXTTS_CPU_LATENTS of the card's latents,
        # on the card and on the CPU
        lat = run["stream"][:INDEXTTS_CPU_LATENTS]
        hold("vocoder audio", model.bigvgan(lat[None], mel_card)[0],
             cpu.bigvgan(lat.cpu()[None], mel_card.cpu())[0])
    out["max_abs_err"] = errs
    print(f"indextts card against the CPU ({time.perf_counter() - t0:.1f} s; prompt of "
          f"{n_prompt} positions, {g.stop_mel_token} the stop code): " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()) + f" (atol {TOL['atol']}, rtol "
          f"{TOL['rtol']}); codes against the CPU's argmax {json.dumps(out['codes'])}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: Kokoro-82M in bf16, and the bf16 runs of phases 8 and 11
# ---------------------------------------------------------------------------

BF16_BENCH_BATCH = 32  # bench.py's default batch, at which it runs bf16
# the bf16 variants' launches a bench iteration (duration and synthesis
# stages): phase 4's float32 counts
KOKORO_BF16_PER_SYNTHESIS = {"dilated_conv1d_bf16": 21, "banded_conv1d_bf16": 36,
                             "lstm_bf16": 12}
# bf16 audio on the card against the same weights and inputs in bf16 on the
# CPU (relative RMS): both round to bf16 at the same places, but cuBLAS,
# cuDNN and the kernels sum in other orders than the CPU, a last-bit
# difference that random weights amplify.  Measured on one H100: Kokoro's
# generate 1.7e-4 (its float32 reference promotes most of the graph to
# float32), EnCodec 7.1e-3 (and its encoder output).  BigVGAN-v2's bf16
# audio is held to the same weights run in float32 on the card (against the
# CPU in bf16 it measured 1.25e-2)
KOKORO_BF16_CPU_REL_RMS = 2e-3
BIGVGAN_BF16_F32_REL_RMS = 5e-2
ENCODEC_BF16_CPU_REL_RMS = 3e-2
# Kokoro audio is compared from this sample on: the source's first STFT
# frame is symmetric and its phase +-pi by rounding (tests/test_torch_kokoro.py)
KOKORO_HEAD = 2400
# a card's code that differs from the CPU's must be, on the card's own
# encoder output x, the nearest or within one bf16 step (2^-7) of
# |x|^2 + |e|^2 of the nearest: the bf16 quantizer forms each distance as
# |x|^2 - 2 x.e + |e|^2, each term rounded to bf16
CODE_TIE_SHARE = 2.0 ** -7


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).pow(2).mean().sqrt() / (want.pow(2).mean().sqrt() + 1e-12))


def _check_only(name: str, lc: dict, want: dict) -> None:
    """The launches of run ``name``: exactly ``want``, and none of any other
    kernel (the float32 variants included)."""
    from mlx_audio_tpu_torch.nn import kernels

    got = {k: v for k, v in lc.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        fail(f"{name}: launches {got}, expected {want} and no other kernel "
             f"(of {sorted(kernels.LAUNCHES)})")


def kokoro_bf16_runs(launches: dict, f32_bench: dict, voice_path: str,
                     before_bench=lambda: None) -> dict:
    """Phase 13: Kokoro-82M cast with .to(torch.bfloat16) at bench.py's own
    shape (batch 32, phoneme bucket 512, frame bucket 1300, durations capped
    at alternating 2/3, the reference and speed in bf16): one iteration
    with every conv and lstm launch recorded and held to its plain version
    on the path's operands, then (after ``before_bench()``) the median of 5
    synced iterations, peak memory and one profiled iteration; every launch
    must be of a bf16 variant, KOKORO_BF16_PER_SYNTHESIS a synthesis.  Then
    ``generate`` on the card against the same bf16 weights on the CPU."""
    from mlx_audio_tpu_torch.models.tts.kokoro import Model
    from mlx_audio_tpu_torch.models.tts.kokoro.presets import kokoro_82m_config
    from mlx_audio_tpu_torch.nn import kernels

    t0 = time.perf_counter()
    model = Model(kokoro_82m_config(), device="cuda").to(torch.bfloat16)
    run_once = bench_runner(model, BF16_BENCH_BATCH, torch.bfloat16)
    conv_calls, lstm_calls, wall = {}, {}, {}
    run = path_runner(launches, wall)
    convs = record_conv_calls(conv_calls)
    lstm = record_lstm_calls(lstm_calls)
    try:
        with torch.no_grad():
            audio, total, _, _ = run("kokoro_bf16_path", lambda: run_once(1_000_001))
    finally:
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
        kernels.lstm = lstm
    # the ISTFT is a float32 island (as in the JAX package): the audio is float32
    if audio.dtype != torch.float32 or not bool(torch.isfinite(audio).all()):
        fail(f"kokoro bf16: audio {audio.dtype}, finite {bool(torch.isfinite(audio).all())}")
    _check_only("kokoro_bf16_path", launches["kokoro_bf16_path"], KOKORO_BF16_PER_SYNTHESIS)
    conv_err = check_conv_path(conv_calls, convs, "Kokoro bf16 bench")
    lstm_err = check_lstm_path(lstm_calls, lstm, "Kokoro bf16 bench")
    path_shapes = {**_per_kernel(conv_calls), "lstm_bf16": len(lstm_calls)}
    del conv_calls, lstm_calls, audio, total
    torch.cuda.empty_cache()

    before_bench()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    bench = bench_pass(run_once, batch=BF16_BENCH_BATCH)
    launches["kokoro_bf16_bench"] = dict(kernels.LAUNCHES)
    routes = dict(kernels.LSTM_ROUTE_LAUNCHES)
    _check_only("kokoro_bf16_bench", launches["kokoro_bf16_bench"],
                {k: v * bench["calls"] for k, v in KOKORO_BF16_PER_SYNTHESIS.items()})
    if routes["row"]:
        fail(f"kokoro bf16: lstm launches by route {routes}")
    card = gpu_line()
    print(f"bench pass (batch {BF16_BENCH_BATCH}, {N_BUCKET} phonemes, {F_BUCKET} frames, "
          f"bf16, bench.py's shape and dtype): {bench['audio_seconds_per_second']:.2f} "
          f"audio-s/s, median {bench['median_s']:.4f} s per iteration, "
          f"{bench['audio_seconds_per_iter']:.1f} audio-s per iteration (duration stage "
          f"{bench['duration_stage_s']:.4f} s, synthesis stage {bench['synthesis_stage_s']:.4f} "
          f"s; iterations {', '.join(f'{t:.4f}' for t in bench['iter_s'])} s), peak "
          f"{bench['peak_memory_gb']:.2f} GB; beside phase 4's float32 (batch {BENCH_BATCH}) "
          f"{f32_bench['audio_seconds_per_second']:.2f} audio-s/s; launches a synthesis "
          f"{json.dumps({k: v // bench['calls'] for k, v in launches['kokoro_bf16_bench'].items() if v})}"
          f", lstm by route {json.dumps(routes)}; built and checked in "
          f"{time.perf_counter() - t0:.1f} s; on {card}", flush=True)
    profile_pass(run_once)
    del run_once
    torch.cuda.empty_cache()
    cpu = kokoro_bf16_card_against_cpu(model, voice_path, launches)
    return {"bench": bench, "conv_path_err": conv_err, "lstm_path_err": lstm_err,
            "path_shapes": path_shapes, "against_cpu": cpu}


def kokoro_bf16_card_against_cpu(model, voice_path: str, launches: dict) -> dict:
    """One bf16 ``generate`` (and ``synthesize_batch`` for its durations) on
    the card and through the same bf16 weights on the CPU, both fed the
    source's draws made on the CPU: durations equal, audio within
    KOKORO_BF16_CPU_REL_RMS from sample KOKORO_HEAD on.  The entry points
    take the reference and speed in float32, so promotion runs most of the
    graph in float32, as in the JAX package."""
    from mlx_audio_tpu_torch.models.tts.kokoro import Model, istftnet
    from mlx_audio_tpu_torch.models.tts.kokoro.presets import kokoro_82m_config
    from mlx_audio_tpu_torch.nn import kernels

    text = BATCH_TEXTS[2]
    ref = np.load(voice_path)[len(text) - 1].reshape(1, -1)
    draw = istftnet.source_noise

    def cpu_draws(b, length, harmonics, device, seed=0):
        return tuple(t.to(device) for t in draw(b, length, harmonics, "cpu", seed))

    istftnet.source_noise = cpu_draws
    try:
        kernels.reset_launches()
        card = list(model.generate(text, voice=voice_path, speed=SPEED))
        (_, dur_card), = model.synthesize_batch([text], ref, speeds=SPEED)
        launches["kokoro_bf16_generate"] = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        cpu_model = cpu_twin(lambda: Model(kokoro_82m_config(), device="cpu").to(torch.bfloat16),
                             model)
        cpu = list(cpu_model.generate(text, voice=voice_path, speed=SPEED))
        (_, dur_cpu), = cpu_model.synthesize_batch([text], ref, speeds=SPEED)
        cpu_s = time.perf_counter() - t0
    finally:
        istftnet.source_noise = draw
    a_card = torch.as_tensor(np.concatenate([r.audio for r in card]))
    a_cpu = torch.as_tensor(np.concatenate([r.audio for r in cpu]))
    if not np.array_equal(dur_card, dur_cpu):
        fail(f"kokoro bf16 generate: durations on the card {dur_card.tolist()} differ from "
             f"the CPU's {dur_cpu.tolist()}")
    if a_card.shape != a_cpu.shape or not bool(torch.isfinite(a_card).all()):
        fail(f"kokoro bf16 generate: audio {tuple(a_card.shape)} against the CPU's "
             f"{tuple(a_cpu.shape)}, finite {bool(torch.isfinite(a_card).all())}")
    err = rel_rms(a_card[KOKORO_HEAD:], a_cpu[KOKORO_HEAD:])
    used = {k: v for k, v in launches["kokoro_bf16_generate"].items() if v}
    print(f"kokoro bf16 generate on the card against the CPU ({cpu_s:.1f} s): "
          f"{len(dur_card)} phonemes, {int(dur_card.sum())} frames, durations equal; "
          f"audio {tuple(a_card.shape)}, relative RMS past sample {KOKORO_HEAD} "
          f"{err:.3e} (bound {KOKORO_BF16_CPU_REL_RMS}), max abs "
          f"{float((a_card - a_cpu)[KOKORO_HEAD:].abs().max()):.3e}; launches of the "
          f"card's generate and synthesize_batch {json.dumps(used)}", flush=True)
    if err > KOKORO_BF16_CPU_REL_RMS:
        fail(f"kokoro bf16 generate: audio on the card {err:.3e} (relative RMS) from the CPU's")
    return {"rel_rms": err, "frames": int(dur_card.sum()), "cpu_s": cpu_s}


def bigvgan_bf16_runs(model, launches: dict, run: dict, f32_ms: float) -> dict:
    """Phase 11's BigVGAN-v2 cast to bf16 (``model.to(torch.bfloat16)``) on
    the phase's 10 s mel in bf16 at batch 1: 26 dilated_conv1d_bf16 and 10
    banded_conv1d_bf16 launches and nothing else, each held to its plain
    version on the path's operands; the audio against the same bf16 weights
    and mel upcast and run in float32 on the card (relative RMS)."""
    from mlx_audio_tpu_torch.nn import kernels

    model.to(torch.bfloat16)
    mel = run["mel"][:1].to(torch.bfloat16)
    conv_calls, wall = {}, {}
    runner = path_runner(launches, wall)
    convs = record_conv_calls(conv_calls)
    try:
        y = runner("bigvgan_bf16_forward", lambda: model(mel))
    finally:
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
    _check_only("bigvgan_bf16_forward", launches["bigvgan_bf16_forward"],
                {f"{k}_bf16": v for k, v in BIGVGAN_ROUTED.items()})
    samples = BIGVGAN_FRAMES * int(np.prod(model.config.upsample_rates))
    if (y.shape != (1, samples, 1) or y.dtype != torch.bfloat16
            or not bool(torch.isfinite(y.float()).all())):
        fail(f"bigvgan bf16: audio {tuple(y.shape)} {y.dtype}")
    conv_err = check_conv_path(conv_calls, convs, "BigVGAN bf16")
    path_shapes = _per_kernel(conv_calls)
    del conv_calls
    with torch.no_grad():
        ms = median_ms(lambda: model(mel), 3)
    t0 = time.perf_counter()
    f32 = _float32_copy(model)
    with torch.no_grad():
        ref = f32(mel.float())
    del f32
    err = rel_rms(y, ref)
    print(f"bigvgan bf16: forward of {BIGVGAN_FRAMES} mel frames at batch 1, launches "
          f"{json.dumps({k: v for k, v in launches['bigvgan_bf16_forward'].items() if v})}; "
          f"{ms:.4f} ms a forward (real-time factor {ms / 1e3 / BIGVGAN_SECONDS:.5f}; float32 "
          f"{f32_ms:.4f} ms); against the same weights in float32 on the card "
          f"({time.perf_counter() - t0:.1f} s): relative RMS {err:.3e} (bound "
          f"{BIGVGAN_BF16_F32_REL_RMS}), max abs {float((y.float() - ref).abs().max()):.3e}"
          f"; on {gpu_line()}", flush=True)
    if err > BIGVGAN_BF16_F32_REL_RMS:
        fail(f"bigvgan bf16: the audio is {err:.3e} (relative RMS) from float32's")
    return {"forward_ms": ms, "rel_rms": err, "conv_path_err": conv_err,
            "conv_path_shapes": path_shapes}


def _code_flips(ref, codes_card, codes_cpu, latent_card, latent_cpu) -> list:
    """At each frame whose codes differ between the card and the CPU, the
    first differing codebook's squared distances (float32) to the card's
    code and to the CPU's, from the card's residual and from the CPU's
    (the codes before it agree), and the scale of the card's bf16
    distances, |residual|^2 + the larger |code|^2: [(level, frame, card a,
    card b, CPU a, CPU b, scale)], a the card's code, b the CPU's."""
    flips = []
    with torch.no_grad():
        for frame in sorted({int(f) for f in (codes_card != codes_cpu).nonzero()[:, 1]}):
            level = int((codes_card[:, frame] != codes_cpu[:, frame]).nonzero()[0])
            emb = ref.quantizer.layers[level].codebook.embed.float()
            pair = [emb[int(c[level, frame])] for c in (codes_card, codes_cpu)]
            dist = []
            for latent in (latent_card, latent_cpu):
                residual = latent[frame].float()
                for i in range(level):
                    residual = residual - ref.quantizer.layers[i].decode(
                        codes_cpu[i, frame]).float()
                dist += [float(((residual - e) ** 2).sum()) for e in pair]
                if latent is latent_card:
                    scale = float((residual ** 2).sum()) + max(
                        float((e ** 2).sum()) for e in pair)
            flips.append((level, frame, *dist, scale))
    return flips


def encodec_bf16_runs(codec, launches: dict, lstm_routes: dict) -> dict:
    """Phase 8's EnCodec-24kHz cast to bf16 on the phase's 3 s clip in bf16
    at 6 kbps: encode and decode launch lstm_bf16 4 times, all on the row
    route, and nothing else; lstm held to its plain version on the path's
    operands; against the same bf16 weights and clip on the CPU: the
    encoder's output within ENCODEC_BF16_CPU_REL_RMS, every code the CPU's
    or, on the card's own encoder output, within CODE_TIE_SHARE of the
    nearest, and the card's codes decoded on both within
    ENCODEC_BF16_CPU_REL_RMS."""
    from mlx_audio_tpu_torch.codec.encodec import Encodec, preprocess_audio
    from mlx_audio_tpu_torch.nn import kernels

    codec.to(torch.bfloat16)
    sr = codec.config.sampling_rate
    audio = (np.random.default_rng(0).standard_normal(int(ENCODEC_SECONDS * sr))
             * 0.1).astype(np.float32)
    x, mask = preprocess_audio(audio, sr)
    x = x.to(torch.bfloat16)
    path_calls, wall = {}, {}
    run = path_runner(launches, wall)
    lstm = record_lstm_calls(path_calls)

    def encode_decode():
        codes, scales = codec.encode(x, mask, bandwidth=ENCODEC_BANDWIDTH)
        return codes, codec.decode(codes, scales, mask)

    try:
        codes, y = run_counted(run, "encodec_bf16_encode_decode", encode_decode, lstm_routes)
    finally:
        kernels.lstm = lstm
    _check_only("encodec_bf16_encode_decode", launches["encodec_bf16_encode_decode"],
                {"lstm_bf16": 4})
    _check_row_route("encodec_bf16_encode_decode", lstm_routes["encodec_bf16_encode_decode"], 4)
    if y.dtype != torch.bfloat16 or not bool(torch.isfinite(y.float()).all()):
        fail(f"encodec bf16: audio {y.dtype}")
    path_err = check_lstm_path(path_calls, lstm, "EnCodec bf16")
    t0 = time.perf_counter()
    ref = cpu_twin(lambda: Encodec(codec.config, device="cpu").to(torch.bfloat16), codec)
    codes_ref, scales_ref = ref.encode(x, mask, bandwidth=ENCODEC_BANDWIDTH)
    codes = codes.cpu()
    y_ref = ref.decode(codes, scales_ref, mask)
    cpu_s = time.perf_counter() - t0
    with torch.no_grad():
        latent_card = codec.encoder(x.to(codec.device))[0].cpu()
        latent_cpu = ref.encoder(x)[0]
    latent_err = rel_rms(latent_card, latent_cpu)
    flips = _code_flips(ref, codes[0, 0], codes_ref[0, 0], latent_card, latent_cpu)
    far = [f for f in flips if f[2] > f[3] + CODE_TIE_SHARE * f[6]]
    err = rel_rms(y, y_ref)
    print(f"encodec bf16 ({ENCODEC_SECONDS} s, {ENCODEC_BANDWIDTH} kbps): launches "
          f"{json.dumps({k: v for k, v in launches['encodec_bf16_encode_decode'].items() if v})}"
          f", lstm by route {json.dumps(lstm_routes['encodec_bf16_encode_decode'])}; against "
          f"the CPU in bf16 ({cpu_s:.1f} s): encoder output relative RMS {latent_err:.3e}; "
          f"codes differing {int((codes != codes_ref).sum())} of {codes.numel()} at "
          f"{len(flips)} frames, the first differing codebook's distances (card's code, "
          f"CPU's) from the card's encoder output and the CPU's "
          f"{[tuple(round(v, 6) for v in f[2:6]) for f in flips[:4]]}, the largest card gap "
          f"{max([(f[2] - f[3]) / f[6] for f in flips], default=0.0):.3e} of its distances' "
          f"scale, {len(far)} past a bf16 step; the card's codes decoded on both: "
          f"relative RMS {err:.3e} (bound {ENCODEC_BF16_CPU_REL_RMS}); wall s "
          f"{json.dumps(wall)}", flush=True)
    if latent_err > ENCODEC_BF16_CPU_REL_RMS:
        fail(f"encodec bf16: the encoder's output is {latent_err:.3e} (relative RMS) from "
             "the CPU's")
    if far:
        fail(f"encodec bf16: a code on the card is not the nearest to its encoder output: "
             f"{far[:4]}")
    if err > ENCODEC_BF16_CPU_REL_RMS:
        fail(f"encodec bf16: the decode on the card is {err:.3e} (relative RMS) from the CPU's")
    return {"rel_rms": err, "latent_rel_rms": latent_err, "code_flip_frames": len(flips),
            "lstm_path_err": path_err,
            "lstm_path_shapes": len(path_calls), "wall": wall}


# ---------------------------------------------------------------------------
# the int8 LMs in bf16: the ends of phases 5, 6, 7, 9 and 10
# ---------------------------------------------------------------------------

# the bf16 LM runs, whose launches the kernels line counts for
# quantized_matmul_bf16
BF16_LM_RUNS = ("csm_bf16_generate", "csm_bf16_generate_spec", "orpheus_bf16_generate",
                "outetts_bf16_generate", "spark_bf16_generate", "voxtral_bf16_generate")
# teacher-forced steps of a bf16 run held against the CPU (Spark's and
# Voxtral's, whose float32 runs are held against it too)
BF16_TF_STEPS = 4
# the card's bf16 logits against the CPU's, which runs the same bf16 weights
# (dequantized once, upcast exactly) in float32 (relative RMS): the card
# rounds activations, caches and the products' outputs to bf16, the CPU
# does not.  The CPU twins of tests/test_torch_bf16_lm.py hold the port's
# bf16 LMs to the JAX package's within the same bound
BF16_LM_CPU_REL_RMS = 3e-2


def bf16_step(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |v|: 2^(e - 7) for 2^e <= |v| < 2^(e + 1)."""
    return torch.exp2(torch.floor(torch.log2(v.double().abs().clamp(min=1e-30))) - 7)


def _bf16_near_tie(logits: torch.Tensor) -> tuple:
    """(margin, bf16 step) of one row of logits: its winner's lead over the
    runner-up, and the spacing of bf16 values at the winner's logit."""
    two = torch.topk(logits.double().flatten(), 2).values
    return float(two[0] - two[1]), float(bf16_step(two[0]))


def check_bf16_lm_launches(name: str, lc: dict, need=(), f32_qmm: int = 0,
                           f32_kernels: dict = None) -> None:
    """A bf16 LM run's launches: quantized_matmul_bf16 and every kernel of
    ``need``; of the kernels with a bf16 variant, the float32 one
    (quantized_matmul ``f32_qmm`` times, the others as ``f32_kernels``
    gives them, 0 by default): no fallback from bf16 to float32."""
    from mlx_audio_tpu_torch.nn import kernels

    missing = [k for k in ("quantized_matmul_bf16", *need) if lc[k] == 0]
    if missing:
        fail(f"{name}: kernels never launched: {missing}")
    want = dict(f32_kernels or {}, quantized_matmul=f32_qmm)
    f32 = {k: lc[k] for k in kernels.BF16_KERNELS}
    if f32 != {k: want.get(k, 0) for k in f32}:
        fail(f"{name}: float32 launches {f32}, expected {want} and no other")


def _penalized_rows(logits: torch.Tensor, tokens, penalty: float, context: int):
    """The decode loop's repetition penalty on the rows of teacher-forced
    logits: row t (t >= 1) penalizes the tokens generated in the
    ``context`` steps before it; row 0 comes from the prefill, unpenalized."""
    out = logits.clone()
    for t in range(1, out.shape[0]):
        for v in set(tokens[max(0, t - context):t]):
            out[t, v] = out[t, v] / penalty if out[t, v] > 0 else out[t, v] * penalty
    return out


def _bf16_tie_check(name: str, card_tokens, cpu_logits) -> dict:
    """The card's tokens against the CPU's argmax: equal wherever the CPU's
    winner beats its runner-up by more than one bf16 step of its logit."""
    two = torch.topk(cpu_logits, 2, dim=-1).values
    return _tie_check(name, card_tokens, cpu_logits, bf16_step(two[:, 0]).float())


def csm_bf16_runs(model, launches: dict, f32_run: dict) -> dict:
    """The phase's CSM-1B cast with cast_lm(torch.bfloat16) (the backbone and
    depth decoder; the RoPE tables, Mimi and the watermark float32) and the
    draft packed again from the bf16 weights' float32 upcasts, as the JAX
    package packs them: greedy generate of CSM_FRAMES without and with spec
    decode.  Both launch quantized_matmul_bf16 and never the float32 kernel,
    the spec run depth_draft too (fed float32 caches); every launch is held
    to its plain version on the path's operands.  The frames must be equal;
    where a frame differs, its first differing code must be a near-tie of
    the plain run's logits there (the winner within one bf16 step of the
    runner-up), counted; the frames after it follow another history and
    are not compared.  Frames a second beside the float32 run's."""
    from mlx_audio_tpu_torch.nn import kernels

    sm = model.model
    sm.spec_decode = False
    t0 = time.perf_counter()
    model.cast_lm(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cast_s = time.perf_counter() - t0
    dtypes = {str(t.dtype) for k, t in sm.state_dict().items()
              if t.is_floating_point() and "rope_" not in k}
    if dtypes != {"torch.bfloat16"} or sm.backbone.rope_cos.dtype != torch.float32:
        fail(f"csm bf16: cast_lm left {dtypes}, RoPE {sm.backbone.rope_cos.dtype}")
    ref = (np.random.default_rng(0).standard_normal(48_000) * 0.1).astype(np.float32)
    kw = dict(ref_audio=ref, ref_text=CSM_REF_TEXT, max_audio_length_ms=CSM_FRAMES * 80,
              temperature=0.0)
    decoded, head_rows = [], []
    decode, head = model.mimi.decode, sm.head_logits

    def recording_decode(codes):
        decoded.append(codes.clone())
        return decode(codes)

    def recording_head(h, i):
        out = head(h, i)
        if not sm.spec_decode:
            head_rows.append(out.detach())
        return out

    path_calls, wall = {}, {}
    qmm = record_qmm_calls(path_calls)
    model.mimi.decode, sm.head_logits = recording_decode, recording_head
    run = path_runner(launches, wall)
    try:
        plain = run("csm_bf16_generate", lambda: list(model.generate(CSM_TEXT, **kw)))
        sm.enable_spec_decode()
        sm.spec_stats = [0, 0]
        spec = run("csm_bf16_generate_spec", lambda: list(model.generate(CSM_TEXT, **kw)))
        accept = sm.spec_stats[:]
    finally:
        model.mimi.decode = decode
        del sm.head_logits
        kernels.quantized_matmul = qmm
    _check_results("csm bf16 generate", plain, CSM_FRAMES)
    _check_results("csm bf16 generate (spec)", spec, CSM_FRAMES)
    check_bf16_lm_launches("csm_bf16_generate", launches["csm_bf16_generate"])
    check_bf16_lm_launches("csm_bf16_generate_spec", launches["csm_bf16_generate_spec"],
                           need=("depth_draft",))
    stats = {}
    path_err = check_qmm_path(path_calls, qmm, "CSM bf16", stats)
    # the spec run's frames against the plain run's; the plain run's head
    # logits come 31 a frame (codebooks 1..31) in frame order
    nc = sm.audio_num_codebooks
    a, b = decoded[0][0], decoded[1][0]          # [nc, frames]
    if len(head_rows) != (nc - 1) * a.shape[1]:
        fail(f"csm bf16: {len(head_rows)} head products in the plain run of "
             f"{a.shape[1]} frames")
    differ = (a != b).any(0).nonzero().flatten().tolist()
    tie = None
    if differ:
        f = differ[0]
        k = int((a[:, f] != b[:, f]).nonzero()[0])
        if k == 0:
            fail(f"csm bf16: spec decode's frame {f} differs from the plain one at "
                 "codebook 0, which both take from the same backbone step")
        margin, step = _bf16_near_tie(head_rows[f * (nc - 1) + k - 1])
        tie = {"frame": f, "codebook": k, "margin": margin, "bf16_step": step}
        if margin > step:
            fail(f"csm bf16: spec decode's frame {f} differs from the plain one at codebook "
                 f"{k}, where the plain run's winner leads by {margin:.4e}, more than one "
                 f"bf16 step ({step:.4e})")
    f32_fps = CSM_FRAMES / f32_run["wall"]["csm_generate_spec"]
    out = {"frames_equal": not differ, "first_near_tie": tie,
           "near_ties": int(bool(differ)), "accept": accept,
           "frames_per_s": CSM_FRAMES / wall["csm_bf16_generate_spec"],
           "frames_per_s_f32": f32_fps,
           "frames_per_s_plain": CSM_FRAMES / wall["csm_bf16_generate"],
           "qmm_path_err": path_err, "qmm_path_steps": stats["bf16_steps"],
           "qmm_path_shapes": len(path_calls), "cast_s": cast_s}
    print(f"csm bf16 (cast_lm, {CSM_FRAMES} frames): spec-decode frames "
          + ("equal to the plain ones" if not differ else
             f"equal to the plain ones up to frame {differ[0]}, whose first differing code "
             f"is a near-tie of the plain run {json.dumps(tie)}")
          + f"; draft accepted {accept[0]} of {accept[1]}; spec generate "
          f"{out['frames_per_s']:.3f} frames/s (float32 {f32_fps:.3f}), plain "
          f"{out['frames_per_s_plain']:.3f}; launches "
          + json.dumps({k: {n: v for n, v in launches[k].items() if v}
                        for k in ("csm_bf16_generate", "csm_bf16_generate_spec")})
          + f"; wall s {json.dumps(wall)}; on {gpu_line()}", flush=True)
    return out


def _lm_bf16_run(label: str, model, launches: dict, generate, tokens: int,
                 f32_wall: float, need=(), f32_qmm: int = 0, f32_kernels=None) -> dict:
    """One bf16 run of a family cast with .to(torch.bfloat16): ``generate()``
    under the launch counters, every quantized_matmul and conv launch held
    to its plain version on the path's operands; tokens a wall second of
    ``generate`` beside the float32 run's of the same depth (``f32_wall``;
    each the phase's first run in its dtype, so both carry first-call
    costs)."""
    from mlx_audio_tpu_torch.nn import kernels

    path_calls, conv_calls, wall = {}, {}, {}
    qmm = record_qmm_calls(path_calls)
    convs = record_conv_calls(conv_calls)
    run = path_runner(launches, wall)
    name = f"{label}_bf16_generate"
    try:
        results = run(name, generate)
    finally:
        kernels.quantized_matmul = qmm
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
    out = {"results": results, "wall_s": wall[name], "tokens_per_s": tokens / wall[name],
           "tokens_per_s_f32": tokens / f32_wall}
    print(f"{label} bf16: generate of {tokens} tokens {out['tokens_per_s']:.3f} tokens a "
          f"wall second (float32 {out['tokens_per_s_f32']:.3f}); launches "
          f"{json.dumps({k: v for k, v in launches[name].items() if v})}; conv shapes "
          f"{sorted(conv_calls)}; on {gpu_line()}", flush=True)
    check_bf16_lm_launches(name, launches[name], need, f32_qmm, f32_kernels)
    stats = {}
    path_err = check_qmm_path(path_calls, qmm, f"{label} bf16", stats)
    conv_err = check_conv_path(conv_calls, convs, f"{label} bf16") if conv_calls else {}
    out.update(qmm_path_err=path_err, qmm_path_steps=stats["bf16_steps"],
               qmm_path_shapes=len(path_calls), conv_path_err=conv_err,
               conv_path_shapes=_per_kernel(conv_calls))
    return out


def lm_decode_rate(lm, rows, penalty: float, context: int, steps: int = PROFILE_STEPS,
                   profile_label: str = None):
    """Batch-1 greedy decode tokens/s of the causal loop's own steps, as
    lm_breakdown times them, warm: the prompt prefilled, 2 steps, then
    ``steps`` timed, synced.  With ``profile_label``, then ``steps`` more
    under the profiler: returns (tokens/s, the profile's idle share,
    kernels a step and device ms a step)."""
    from mlx_audio_tpu_torch.models.lm import causal

    caches, pad_len, prompt, pen, window = causal._start(lm, rows, 2 * steps + 2, None,
                                                         penalty, context)
    last = causal._prefill(lm, caches, pad_len, prompt).argmax(-1).to(torch.int32)
    window[:, -1] = last

    def run(n):
        nonlocal window, last
        _, window, last = causal._decode_chunk(lm, caches, pad_len, last, window, n, 0.0,
                                               0, 1.0, pen, None)

    run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    rate = steps / (time.perf_counter() - t0)
    if profile_label is None:
        return rate
    prof = profile_steps(profile_label, lambda: run(steps), steps) or {}
    return rate, {k: prof.get(k) for k in ("profile_idle_share", "launches_per_step",
                                           "device_ms_per_step")}


def _cast_bf16(model) -> float:
    t0 = time.perf_counter()
    model.to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def orpheus_bf16_runs(model, launches: dict, f32_run: dict) -> dict:
    """The phase's Orpheus-3B cast with .to(torch.bfloat16) (the int8 LM's
    scales and biases, its norms and RoPE tables, and SNAC): greedy generate
    of ORPHEUS_TOKENS; quantized_matmul_bf16 only.  The decode rate at
    batch 1 in float32, then in bf16 (lm_decode_rate)."""
    rows = model.prepare_input_ids([ORPHEUS_TEXT], "tara")
    f32_rate = lm_decode_rate(model.lm, rows, 1.3, 20)
    cast_s = _cast_bf16(model)
    out = _lm_bf16_run("orpheus", model, launches, lambda: list(model.generate(
        ORPHEUS_TEXT, voice="tara", temperature=0.0, max_tokens=ORPHEUS_TOKENS)),
        ORPHEUS_TOKENS, f32_run["wall"]["orpheus_generate"])
    _check_orpheus("orpheus bf16 generate", out.pop("results"), rows)
    out.update(cast_s=cast_s, decode_tokens_per_s_f32=f32_rate,
               decode_tokens_per_s=lm_decode_rate(model.lm, rows, 1.3, 20))
    return out


def outetts_bf16_runs(model, launches: dict, f32_run: dict) -> dict:
    """The phase's OuteTTS-1B cast with .to(torch.bfloat16), and its 24 kHz
    DAC cast too: the default DAC is built on first use and held by the
    audio processor, not by the model, so ``.to`` does not reach it (nor
    does the JAX package's ``astype``).  Greedy generate of OUTETTS_TOKENS:
    quantized_matmul_bf16 and both conv kernels' bf16 variants, no float32
    kernel.  The decode rate at batch 1 in float32, then in bf16, and a
    profile of PROFILE_STEPS bf16 steps."""
    from mlx_audio_tpu_torch.models.tts.outetts import PromptProcessor
    from mlx_audio_tpu_torch.models.tts.outetts import outetts as outetts_mod

    rows = _outetts_rows(model, [OUTETTS_TEXT])
    f32_rate = lm_decode_rate(model.lm, rows, 1.1, 64)
    cast_s = _cast_bf16(model) + _cast_bf16(model.audio_processor.audio_codec.model)
    tokens, gen_fn = [], outetts_mod.generate_tokens

    def recording_gen(*a, **k):
        for chunk in gen_fn(*a, **k):
            tokens.extend(int(t) for t in chunk)
            yield chunk

    outetts_mod.generate_tokens = recording_gen
    try:
        out = _lm_bf16_run("outetts", model, launches, lambda: list(model.generate(
            OUTETTS_TEXT, temperature=0.0, max_tokens=OUTETTS_TOKENS)),
            OUTETTS_TOKENS, f32_run["wall"]["outetts_generate"],
            need=("banded_conv1d_bf16", "dilated_conv1d_bf16"))
    finally:
        outetts_mod.generate_tokens = gen_fn
    _check_outetts("outetts bf16 generate", out.pop("results"), 1)
    codes = [t for t in tokens if OUTETTS_CODES <= t < OUTETTS_CODES + 2 * 1025]
    rate, prof = lm_decode_rate(model.lm, rows, 1.1, 64, profile_label="outetts bf16")
    out.update(cast_s=cast_s, tokens=len(tokens), codes=len(codes),
               distinct_codes=len(set(codes)), decode_tokens_per_s_f32=f32_rate,
               decode_tokens_per_s=rate, profile=prof,
               frames=len(PromptProcessor(model._tokenizer).extract_audio_from_tokens(
                   tokens)[0]))
    if len(tokens) != OUTETTS_TOKENS:
        fail(f"outetts bf16: greedy generate stopped after {len(tokens)} tokens")
    return out


def spark_bf16_runs(model, launches: dict, f32_run: dict) -> dict:
    """The phase's Spark-TTS-0.5B cast with .to(torch.bfloat16) (the int8
    LM and BiCodec; wav2vec2, which the audio tokenizer holds, is not the
    model's and stays float32, as under the JAX package's astype): greedy
    control-mode generate of SPARK_TOKENS, quantized_matmul_bf16 in every
    step.  BiCodec's speaker embedding comes out of its FSQ codes in
    float32 and promotes the prenet and the wave generator to float32, as
    in the JAX package, so the wave generator launches the float32 conv
    kernels (banded at d = 1, dilated at d = 3 and 9) and no bf16 one.
    Then held against the CPU."""
    from mlx_audio_tpu_torch.models.tts.spark import spark as spark_mod

    rows = _spark_rows(model, [SPARK_TEXT])
    f32_rate = lm_decode_rate(model.lm, rows, 1.3, 20)
    cast_s = _cast_bf16(model)
    tokens, gen_fn = [], spark_mod.generate_tokens

    def recording_gen(*a, **k):
        for chunk in gen_fn(*a, **k):
            tokens.extend(int(t) for t in chunk)
            yield chunk

    spark_mod.generate_tokens = recording_gen
    try:
        out = _lm_bf16_run("spark", model, launches, lambda: list(model.generate(
            SPARK_TEXT, temperature=0.0, max_tokens=SPARK_TOKENS)),
            SPARK_TOKENS, f32_run["wall"]["spark_generate"],
            f32_kernels={"banded_conv1d": 1, "dilated_conv1d": 2})
    finally:
        spark_mod.generate_tokens = gen_fn
    _check_spark("spark bf16 generate", out.pop("results"), 1)
    if len(tokens) != SPARK_TOKENS:
        fail(f"spark bf16: {len(tokens)} tokens, not {SPARK_TOKENS}")
    out.update(cast_s=cast_s, decode_tokens_per_s_f32=f32_rate,
               decode_tokens_per_s=lm_decode_rate(model.lm, rows, 1.3, 20),
               against_cpu=spark_bf16_card_against_cpu(model, tokens),
               distinct=len(set(tokens)))
    return out


def spark_bf16_card_against_cpu(model, tokens) -> dict:
    """The bf16 greedy run's prompt and first BF16_TF_STEPS tokens fed,
    teacher-forced, through the card's bf16 int8 LM and through the same
    bf16 weights on the CPU (dequantized once on the card, upcast, moved),
    run in float32: logits
    within BF16_LM_CPU_REL_RMS; the card's tokens equal to the CPU's argmax
    under the loop's penalty (1.3, a window of 20) wherever its winner
    beats its runner-up by more than one bf16 step of its logit."""
    import copy

    from mlx_audio_tpu_torch.models.lm import causal
    from mlx_audio_tpu_torch.nn.quantize import dequantize_model

    prompt = _spark_rows(model, [SPARK_TEXT])[0]
    toks = tokens[:BF16_TF_STEPS + 1]

    def logits(lm):
        dev = lm.model.rope_cos.device
        caches, pad_len, ids, _, _ = causal._start(lm, [prompt], BF16_TF_STEPS + 1, None,
                                                   1.0, 1)
        out = [causal._prefill(lm, caches, pad_len, ids)]
        with torch.no_grad():
            for t in toks[:-1]:
                h, _ = lm.model.step(caches, torch.tensor([[t]], device=dev), pad_len)
                out.append(lm.logits(h[:, -1]).float())
        return torch.cat([o.cpu() for o in out])

    t0 = time.perf_counter()
    card = logits(model.lm)
    cpu_lm = dequantize_model(copy.deepcopy(model.lm)).float().cpu()
    cpu = logits(cpu_lm)
    del cpu_lm
    err = rel_rms(card, cpu)
    ties = _bf16_tie_check("spark bf16 greedy tokens", toks,
                           _penalized_rows(cpu, toks, 1.3, 20))
    print(f"spark bf16 card against the CPU (the same bf16 weights in float32, "
          f"{time.perf_counter() - t0:.1f} s): the prefill's and {BF16_TF_STEPS} "
          f"teacher-forced steps' logits {tuple(card.shape)}, relative RMS {err:.3e} (bound "
          f"{BF16_LM_CPU_REL_RMS}); greedy tokens against the CPU's argmax {json.dumps(ties)}",
          flush=True)
    if err > BF16_LM_CPU_REL_RMS:
        fail(f"spark bf16: teacher-forced logits on the card are {err:.3e} (relative RMS) "
             "from the CPU's")
    return {"rel_rms": err, "tokens": ties}


def voxtral_bf16_runs(model, launches: dict, f32_run: dict) -> dict:
    """The phase's Voxtral-Mini-3B cast with .to(torch.bfloat16): greedy
    generate of one 30 s window, VOXTRAL_TOKENS tokens.  The float32 log-mel
    promotes through the bf16 audio tower (its conv1 on the float32
    dilated_conv1d, once) and the prompt's float32 audio embeddings through
    the prefill, as the JAX package's jnp.where and einsums promote them, so
    the prompt's head takes the float32 quantized_matmul once; every decode
    step runs bf16 over the bf16 cache: quantized_matmul_bf16
    VOXTRAL_QMM_PER_STEP times a step.  The decode rate at batch 1 in
    float32, then in bf16 (voxtral_decode_rate).  Then held against the same
    weights in float32 on the card."""
    clip = f32_run["clip"]
    f32_rate = voxtral_decode_rate(model, clip, f32_run["tokens"])
    cast_s = _cast_bf16(model)
    out = _lm_bf16_run("voxtral", model, launches, lambda: model.generate(
        clip, max_tokens=VOXTRAL_TOKENS), VOXTRAL_TOKENS, f32_run["wall"]["voxtral_generate"],
        f32_qmm=1, f32_kernels={"dilated_conv1d": 1})
    result = out.pop("results")
    tokens = result.segments[0]["tokens"]
    lc = launches["voxtral_bf16_generate"]
    want = (VOXTRAL_TOKENS - 1) * VOXTRAL_QMM_PER_STEP
    if len(tokens) != VOXTRAL_TOKENS or lc["quantized_matmul_bf16"] != want:
        fail(f"voxtral bf16: {len(tokens)} tokens, {lc['quantized_matmul_bf16']} "
             f"quantized_matmul_bf16 launches (expected {VOXTRAL_TOKENS} and {want})")
    out.update(cast_s=cast_s, distinct=len(set(tokens)), decode_tokens_per_s_f32=f32_rate,
               decode_tokens_per_s=voxtral_decode_rate(model, clip, tokens),
               against_f32=voxtral_bf16_against_float32(model, clip, tokens))
    return out


def voxtral_decode_rate(model, clip, tokens, steps: int = PROFILE_STEPS) -> float:
    """Batch-1 decode tokens/s of teacher-forced steps over a window's
    prompt (``_voxtral_steps``), warm: 2 steps, then ``steps`` timed,
    synced."""
    mel, ids = model._prepare_inputs(clip)
    with torch.no_grad():
        caches, pad_len, _, _ = _voxtral_state(model, mel, ids, steps + 4)
        _voxtral_steps(model, caches, pad_len, tokens[:2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _voxtral_steps(model, caches, pad_len, tokens[2:steps + 2])
        torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def voxtral_bf16_against_float32(model, clip, tokens) -> dict:
    """The bf16 run's window through the card's model and through the same
    bf16 weights dequantized once and upcast, run in float32 on the card:
    the logits of the prompt and of BF16_TF_STEPS teacher-forced steps
    within BF16_LM_CPU_REL_RMS, the bf16 run's tokens equal to the float32
    run's argmax wherever its winner beats its runner-up by more than one
    bf16 step of its logit."""
    import copy

    from mlx_audio_tpu_torch.nn.quantize import dequantize_model

    t0 = time.perf_counter()
    mel, ids = model._prepare_inputs(clip)
    toks = tokens[:BF16_TF_STEPS + 1]
    ref = dequantize_model(copy.deepcopy(model)).float()
    res = {}
    with torch.no_grad():
        for name, m in (("bf16", model), ("f32", ref)):
            caches, pad_len, _, first = _voxtral_state(m, mel, ids, len(toks) + 1)
            res[name] = torch.cat([first.cpu(), _voxtral_steps(m, caches, pad_len,
                                                               toks[:-1]).cpu()])
    del ref
    torch.cuda.empty_cache()
    err = rel_rms(res["bf16"], res["f32"])
    ties = _bf16_tie_check("voxtral bf16 greedy tokens", toks, res["f32"])
    print(f"voxtral bf16 against float32 on the card (the same bf16 weights in float32, "
          f"{time.perf_counter() - t0:.1f} s): the prompt's and {BF16_TF_STEPS} "
          f"teacher-forced steps' logits {tuple(res['bf16'].shape)}, relative RMS "
          f"{err:.3e} (bound {BF16_LM_CPU_REL_RMS}); greedy tokens against the float32 "
          f"argmax {json.dumps(ties)}", flush=True)
    if err > BF16_LM_CPU_REL_RMS:
        fail(f"voxtral bf16: logits are {err:.3e} (relative RMS) from float32's")
    return {"rel_rms": err, "tokens": ties}


# ---------------------------------------------------------------------------
# Dia, Bark, Whisper, Parakeet and IndexTTS in bf16: the ends of phases 7,
# 8, 10, 11 and 12
# ---------------------------------------------------------------------------

# the bf16 runs' logits (and Whisper's encoder output) against the same bf16
# weights upcast and run in float32 on the card (relative RMS): the bf16 run
# rounds activations, caches and products to bf16, the float32 run does not;
# Parakeet computes in float32 in both (its float32 log-mel promotes the
# encoder, as in the JAX package), so it differs only in the order of sums.
# The CPU twins of tests/test_torch_bf16_families.py hold these families'
# bf16 to the JAX package's within 3e-2
BF16_F32_REL_RMS = 3e-2
WHISPER_BF16_FEATURES_REL_RMS = 5e-2
# Dia's attention does not scale its scores, and at random weights its
# bf16 logits lie 2.8e-2 (relative RMS) from float32's on one H100; a code
# may differ from the float32 CFG argmax where that winner's lead is within
# this many RMS differences of the two runs' CFG logits at its step
DIA_BF16_F32_REL_RMS = 5e-2
DIA_CFG_NOISE = 3.0
PARAKEET_BF16_F32_REL_RMS = 1e-4


def _float32_copy(module):
    """A float32 copy of a bf16 module on its device: the same weights,
    upcast exactly."""
    import copy

    ref = copy.deepcopy(module).float()
    torch.cuda.synchronize()
    return ref


def _profile_summary(profiles: dict) -> dict:
    """Each profile_steps result's idle share, kernels and device ms (None
    where the profiler recorded no device time)."""
    keys = ("profile_idle_share", "launches_per_step", "device_ms_per_step")
    return {k: v and {n: v[n] for n in keys} for k, v in profiles.items()}


def _check_bf16_dtypes(name: str, *modules) -> None:
    got = {str(p.dtype) for m in modules for p in m.parameters() if p.is_floating_point()}
    if got != {"torch.bfloat16"}:
        fail(f"{name}: .to(torch.bfloat16) left parameters in {sorted(got)}")


def _dia_cfg(logits: torch.Tensor) -> torch.Tensor:
    """Decoder logits [..., 2, C, V] of an (uncond, cond) pair -> the greedy
    pick's CFG logits [..., C, VALID_CLASSES] (top-k does not move the
    argmax)."""
    from mlx_audio_tpu_torch.models.tts.dia.model import VALID_CLASSES

    uncond, cond = logits.double().unbind(-3)
    return (cond + DIA_CFG_SCALE * (cond - uncond))[..., :VALID_CLASSES]


def _dia_cfg_check(name: str, codes, bf16: torch.Tensor, f32: torch.Tensor, delay) -> dict:
    """The bf16 run's greedy codes against the CFG argmax of the same weights
    in float32, over teacher-forced decoder logits [steps, 2, C, V], at
    every step and channel past the channel's delay: equal wherever the
    float32 winner leads by more than DIA_CFG_NOISE times the RMS of the
    two runs' CFG logits' difference at that step and channel (their
    rounding noise: CFG takes 4 cond - 3 uncond, so a bf16 step of either
    logit is a fifth of it or less)."""
    cfg, cfg_bf16 = _dia_cfg(f32), _dia_cfg(bf16)
    free = [(t, c) for t in range(cfg.shape[0]) for c in range(len(delay)) if t >= delay[c]]
    rows = torch.stack([cfg[t, c] for t, c in free])
    tie = torch.stack([DIA_CFG_NOISE * (cfg_bf16[t, c] - cfg[t, c]).pow(2).mean().sqrt()
                       for t, c in free])
    return _tie_check(name, [int(codes[c, t + 1]) for t, c in free], rows, tie)


def dia_bf16_runs(model, launches: dict, f32_run: dict) -> dict:
    """Phase 7's Dia-1.6B cast with .to(torch.bfloat16): the encoder, the
    decoder and the DAC-44kHz given at construction (a DAC loaded on first
    use would stay float32, as under the JAX package's astype).  Greedy
    generate of DIA_STEPS: the caches bf16, the logits float32 (the head
    takes the float32 norm output into its bf16 weight and promotes, as the
    JAX package's does); the DAC decode launches both conv kernels' bf16
    variants as often as the float32 run launched the float32 ones, and no
    other kernel, each held to its plain version on the path's operands.
    Steps a wall second of generate beside the float32 run's; the greedy codes fed,
    teacher-forced, for BF16_TF_STEPS + 1 steps through the bf16 model and
    the same weights in float32 on the card: logits within
    DIA_BF16_F32_REL_RMS, each code past its channel's delay equal to the
    float32 CFG argmax wherever its winner leads by more than the two runs'
    rounding noise there (``_dia_cfg_check``)."""
    from mlx_audio_tpu_torch.models.tts.dia import model as dia_mod
    from mlx_audio_tpu_torch.models.tts.dia.audio import TAIL_DROP
    from mlx_audio_tpu_torch.nn import kernels

    cast_s = _cast_bf16(model)
    _check_bf16_dtypes("dia bf16", model.model, model._get_dac())
    seen, fn = [], dia_mod.codebook_to_audio
    dia_mod.codebook_to_audio = lambda codes, *a, **k: (seen.append(codes), fn(codes, *a, **k))[1]
    conv_calls, wall = {}, {}
    convs = record_conv_calls(conv_calls)
    run = path_runner(launches, wall)
    try:
        (result,) = run("dia_bf16_generate", lambda: list(model.generate(
            DIA_TEXT, temperature=0.0, max_tokens=DIA_STEPS)))
    finally:
        dia_mod.codebook_to_audio = fn
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
    want = {f"{k}_bf16": launches["dia_generate"][k] for k in ("banded_conv1d", "dilated_conv1d")}
    _check_only("dia_bf16_generate", launches["dia_bf16_generate"], want)
    samples = (DIA_STEPS - TAIL_DROP) * model._get_dac().hop_length
    if not (result.samples == samples and result.audio.dtype == np.float32
            and np.isfinite(result.audio).all()):
        fail(f"dia bf16 generate: {result.samples} samples (expected {samples}), audio "
             f"{result.audio.dtype}")
    conv_err = check_conv_path(conv_calls, convs, "Dia bf16")
    codes = seen[0]
    t0 = time.perf_counter()
    n = BF16_TF_STEPS + 1
    bf16 = _dia_tf_logits(model, model.model, codes, n)
    ref = _float32_copy(model.model)
    f32 = _dia_tf_logits(model, ref, codes, n)
    del ref
    torch.cuda.empty_cache()
    err = rel_rms(bf16, f32)
    noise = float((_dia_cfg(bf16) - _dia_cfg(f32)).pow(2).mean().sqrt())
    ties = _dia_cfg_check("dia bf16 greedy codes", codes, bf16, f32,
                          model.config.data.delay_pattern)
    out = {"cast_s": cast_s, "wall_s": wall["dia_bf16_generate"],
           "steps_per_s": DIA_STEPS / wall["dia_bf16_generate"],
           "steps_per_s_f32": DIA_STEPS / f32_run["wall"]["dia_generate"],
           "conv_path_err": conv_err, "conv_path_shapes": _per_kernel(conv_calls),
           "against_f32": {"rel_rms": err, "cfg_rms_diff": noise, "codes": ties}}
    print(f"dia bf16 (.to(torch.bfloat16), the DAC too): generate of {DIA_STEPS} steps "
          f"{out['steps_per_s']:.3f} steps a wall second (float32 {out['steps_per_s_f32']:.3f}); "
          f"launches "
          f"{json.dumps({k: v for k, v in launches['dia_bf16_generate'].items() if v})}; "
          f"against the same weights in float32 on the card ({time.perf_counter() - t0:.1f} "
          f"s): {n} teacher-forced steps' logits {tuple(bf16.shape)}, relative RMS {err:.3e} "
          f"(bound {DIA_BF16_F32_REL_RMS}), their CFG logits' RMS difference {noise:.3e}; "
          f"codes past their channel's delay against the float32 CFG argmax "
          f"{json.dumps(ties)}; on {gpu_line()}", flush=True)
    if err > DIA_BF16_F32_REL_RMS:
        fail(f"dia bf16: teacher-forced logits {err:.3e} (relative RMS) from float32's")
    return out


def bark_bf16_runs(model, launches: dict, lstm_routes: dict, f32_run: dict,
                   f32_info: dict) -> dict:
    """Phase 8's Bark cast with .to(torch.bfloat16), its EnCodec (the
    ``_codec`` given) bf16 too: a greedy-like generate (BARK_SEMANTIC_STEPS
    semantic tokens, every stage at BARK_GREEDY) whose caches are bf16 and
    whose sampled logits and scores are float32, as in the JAX package; its
    EnCodec decode launches lstm_bf16 as often as the float32 run launched
    lstm, all on the row route, and no other kernel, held to its plain
    version on the path's operands; the audio float32 (an exact upcast of
    the bf16 EnCodec's).  Semantic steps/s beside the float32 breakdown's;
    the greedy tokens fed, teacher-forced, through the bf16 GPTs and the
    same weights in float32 on the card (the semantic prefill and
    BF16_TF_STEPS steps, the coarse first window and as many steps, one
    fine forward): logits within BF16_F32_REL_RMS, the semantic and coarse
    tokens equal to the float32 argmax over their classes wherever its
    winner leads by more than one bf16 step."""
    from mlx_audio_tpu_torch.models.tts.bark.bark import (
        CODEBOOK_SIZE,
        SEMANTIC_VOCAB_SIZE,
        _semantic_relevant,
    )
    from mlx_audio_tpu_torch.nn import kernels

    cast_s = _cast_bf16(model)
    _check_bf16_dtypes("bark bf16", model.semantic, model.coarse_acoustics,
                       model.fine_acoustics, model._codec)
    seen = {"semantic": [], "codes": []}
    sem_fn, codec = model.generate_text_semantic_batch, model._codec
    decode_fn = codec.decode
    model.generate_text_semantic_batch = lambda *a, **k: (
        lambda out: (seen["semantic"].append([o.tolist() for o in out]), out)[1])(
            sem_fn(*a, **k))
    codec.decode = lambda codes, *a, **k: (
        seen["codes"].append(torch.as_tensor(codes).cpu().numpy()), decode_fn(codes, *a, **k))[1]
    path_calls, wall = {}, {}
    run = path_runner(launches, wall)
    lstm = record_lstm_calls(path_calls)
    try:
        (result,) = run_counted(run, "bark_bf16_generate", lambda: list(model.generate(
            BARK_TEXT, temperature=BARK_GREEDY, max_steps=BARK_SEMANTIC_STEPS)), lstm_routes)
    finally:
        del model.generate_text_semantic_batch, codec.decode
        kernels.lstm = lstm
    n_lstm = launches["bark_generate"]["lstm"]
    _check_only("bark_bf16_generate", launches["bark_bf16_generate"], {"lstm_bf16": n_lstm})
    _check_row_route("bark_bf16_generate", lstm_routes["bark_bf16_generate"], n_lstm)
    samples = 3 * BARK_SEMANTIC_STEPS // 2 * 320
    if not (result.samples == samples and result.audio.dtype == np.float32
            and np.isfinite(result.audio).all()):
        fail(f"bark bf16 generate: {result.samples} samples (expected {samples}), audio "
             f"{result.audio.dtype}")
    if len(seen["semantic"][0][0]) != BARK_SEMANTIC_STEPS:
        fail(f"bark bf16: {len(seen['semantic'][0][0])} semantic tokens, not the budget")
    path_err = check_lstm_path(path_calls, lstm, "Bark bf16")
    rate = _bark_semantic_rate(model, [BARK_TEXT], torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    tf = _bark_tf_inputs(model, {"semantic": seen["semantic"][0][0], "codes": seen["codes"][0]})
    gpts = (model.semantic, model.coarse_acoustics, model.fine_acoustics)
    bf16 = _bark_tf_logits(*gpts, tf, BF16_TF_STEPS)
    refs = [_float32_copy(g) for g in gpts]
    f32 = _bark_tf_logits(*refs, tf, BF16_TF_STEPS)
    del refs
    torch.cuda.empty_cache()
    n = BF16_TF_STEPS + 1
    errs = {stage: rel_rms(torch.cat(bf16[i:j]), torch.cat(f32[i:j]))
            for stage, i, j in (("semantic", 0, n), ("coarse", n, 2 * n),
                                ("fine", 2 * n, 2 * n + 1))}
    sem_logits = _semantic_relevant(torch.cat(f32[:n]))
    coarse = torch.cat(f32[n:2 * n]).double()
    for i in range(n):
        start = SEMANTIC_VOCAB_SIZE + (i % 2) * CODEBOOK_SIZE
        keep = torch.zeros(coarse.shape[1], dtype=torch.bool)
        keep[start:start + CODEBOOK_SIZE] = True
        coarse[i, ~keep] = float("-inf")
    ties = {"semantic": _bf16_tie_check("bark bf16 semantic tokens",
                                        tf["semantic"][:n], sem_logits),
            "coarse": _bf16_tie_check("bark bf16 coarse tokens",
                                      [int(t) for t in tf["coarse"][:n]], coarse)}
    out = {"cast_s": cast_s, "wall_s": wall["bark_bf16_generate"],
           "semantic_per_wall_s": BARK_SEMANTIC_STEPS / wall["bark_bf16_generate"],
           "semantic_per_wall_s_f32": BARK_SEMANTIC_STEPS / f32_run["wall"]["bark_generate"],
           "semantic_steps_per_s": rate,
           "semantic_steps_per_s_f32": f32_info["semantic_steps_per_s_batch1"],
           "lstm_path_err": path_err, "lstm_path_shapes": len(path_calls),
           "against_f32": {"rel_rms": errs, "tokens": ties}}
    print(f"bark bf16 (.to(torch.bfloat16), EnCodec too): greedy-like generate of "
          f"{BARK_SEMANTIC_STEPS} semantic tokens in {wall['bark_bf16_generate']:.3f} s "
          f"(float32 {f32_run['wall']['bark_generate']:.3f}); semantic {rate:.3f} steps/s "
          f"(float32 {f32_info['semantic_steps_per_s_batch1']:.3f}); launches "
          f"{json.dumps({k: v for k, v in launches['bark_bf16_generate'].items() if v})}, lstm "
          f"by route {json.dumps(lstm_routes['bark_bf16_generate'])}; against the same "
          f"weights in float32 on the card ({time.perf_counter() - t0:.1f} s): teacher-forced "
          f"logits relative RMS {json.dumps(errs)} (bound {BF16_F32_REL_RMS}); tokens against "
          f"the float32 argmax {json.dumps(ties)}; on {gpu_line()}", flush=True)
    if max(errs.values()) > BF16_F32_REL_RMS:
        fail(f"bark bf16: teacher-forced logits {json.dumps(errs)} (relative RMS) from "
             "float32's")
    return out


def whisper_bf16_runs(model, tok, launches: dict, run: dict, f32_info: dict) -> dict:
    """Phase 10's Whisper-large-v3-turbo cast with .to(torch.bfloat16).
    ``decode`` casts the float32 log-mel to conv1's dtype, as the JAX
    package's api does, so the encoder, the cross keys and values and the
    caches run in bf16 and the scores, masks and logits in float32.  One
    encode at batch 4 and a greedy decode of one window (WHISPER_SAMPLE_LEN
    tokens) each launch dilated_conv1d_bf16 once (conv1) and no other
    kernel, held to its plain version on the path's operands; encoder ms a
    window at batch 1 and 4 and tokens/s beside the float32 breakdown's;
    then against the same weights in float32 on the card (a profile of
    one encoder forward in each dtype beside): the encoder's
    output within WHISPER_BF16_FEATURES_REL_RMS, the logits of the prefill
    and BF16_TF_STEPS teacher-forced steps within BF16_F32_REL_RMS, those
    tokens equal to the float32 run's greedy choice (through the same
    filters) wherever its winner leads by more than one bf16 step."""
    from mlx_audio_tpu_torch.models.stt.whisper import DecodingOptions
    from mlx_audio_tpu_torch.nn import kernels

    cast_s = _cast_bf16(model)
    _check_bf16_dtypes("whisper bf16", model)
    mel4 = run["mel4"]
    mel4_bf16 = mel4.to(torch.bfloat16)
    opts = DecodingOptions(language="en")
    conv_calls, wall = {}, {}
    convs = record_conv_calls(conv_calls)
    runner = path_runner(launches, wall)
    try:
        with torch.no_grad():
            feats4 = runner("whisper_bf16_encode", lambda: model.encoder(mel4_bf16))
            result = runner("whisper_bf16_decode", lambda: model.decode(mel4[0], opts))
    finally:
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
    for name in ("whisper_bf16_encode", "whisper_bf16_decode"):
        _check_only(name, launches[name], {"dilated_conv1d_bf16": 1})
    if feats4.dtype != torch.bfloat16 or result.audio_features.dtype != torch.bfloat16:
        fail(f"whisper bf16: audio features {feats4.dtype}, {result.audio_features.dtype}")
    _check_window_tokens("whisper bf16 decode", result.tokens, tok)
    conv_err = check_conv_path(conv_calls, convs, "Whisper bf16")
    with torch.no_grad():
        enc1 = median_ms(lambda: model.encoder(mel4_bf16[:1]), 3)
        enc4 = median_ms(lambda: model.encoder(mel4_bf16), 3)
        g1 = _timed(lambda: model.decode(feats4[0], opts))
    t0 = time.perf_counter()
    n = BF16_TF_STEPS + 1
    ref = _float32_copy(model)
    with torch.no_grad():
        feats = model.encoder(mel4_bf16[:1])
        feats_ref = ref.encoder(mel4[:1])
        prof = {name: profile_steps(f"whisper {name} encoder (batch 1)", fn, 1, KERNEL_GROUPS)
                for name, fn in (("bf16", lambda: model.encoder(mel4_bf16[:1])),
                                 ("float32", lambda: ref.encoder(mel4[:1])))}
    feat_err = rel_rms(feats, feats_ref)
    bf16 = _whisper_tf(model, tok, feats, result.tokens, n)
    f32 = _whisper_tf(ref, tok, feats_ref, result.tokens, n)
    ties = _bf16_tie_check("whisper bf16 greedy tokens", result.tokens[:n],
                           _whisper_tf(ref, tok, feats_ref, result.tokens, n, filtered=True))
    del ref
    torch.cuda.empty_cache()
    err = rel_rms(bf16, f32)
    out = {"cast_s": cast_s, "encoder_ms_batch1": enc1, "encoder_ms_per_window_batch4":
           enc4 / WHISPER_BATCH, "encoder_ms_batch1_f32": f32_info["encoder_ms_batch1"],
           "encoder_ms_per_window_batch4_f32": f32_info["encoder_ms_per_window_batch4"],
           "tokens_per_s": WHISPER_SAMPLE_LEN / g1, "tokens_per_s_f32": f32_info["tokens_per_s"],
           "conv_path_err": conv_err, "conv_path_shapes": _per_kernel(conv_calls),
           "encoder_profile": _profile_summary(prof),
           "against_f32": {"features_rel_rms": feat_err, "rel_rms": err, "tokens": ties}}
    print(f"whisper bf16 (.to(torch.bfloat16)): encoder {enc1:.4f} ms a window at batch 1, "
          f"{enc4 / WHISPER_BATCH:.4f} at batch {WHISPER_BATCH} (float32 "
          f"{f32_info['encoder_ms_batch1']:.4f}, {f32_info['encoder_ms_per_window_batch4']:.4f}"
          f"); greedy decode of a window {out['tokens_per_s']:.3f} tokens/s (float32 "
          f"{f32_info['tokens_per_s']:.3f}); launches "
          + json.dumps({k: {n_: v for n_, v in launches[k].items() if v}
                        for k in ("whisper_bf16_encode", "whisper_bf16_decode")})
          + f"; against the same weights in float32 on the card ({time.perf_counter() - t0:.1f}"
          f" s): encoder output relative RMS {feat_err:.3e} (bound "
          f"{WHISPER_BF16_FEATURES_REL_RMS}), the prefill's and {BF16_TF_STEPS} teacher-forced "
          f"steps' logits {tuple(bf16.shape)} relative RMS {err:.3e} (bound {BF16_F32_REL_RMS})"
          f"; tokens against the float32 greedy choice {json.dumps(ties)}; on {gpu_line()}",
          flush=True)
    if feat_err > WHISPER_BF16_FEATURES_REL_RMS or err > BF16_F32_REL_RMS:
        fail(f"whisper bf16: encoder output {feat_err:.3e}, logits {err:.3e} (relative RMS) "
             "from float32's")
    return out


def parakeet_bf16_runs(model, ctc, launches: dict, run: dict, f32_info: dict) -> dict:
    """Phase 11's Parakeet-TDT-0.6B-v2 and its CTC head cast with
    .to(torch.bfloat16).  The float32 log-mel promotes the first conv, so
    the whole encoder runs in float32 over the bf16 weights (its output
    float32), as do the joint and the prediction net's float32 state, as in
    the JAX package: the TDT decode and the CTC decode of one 30 s window
    launch no kernel of ours.  Encoder ms a window at batch 1 and 4 beside
    the float32 breakdown's; against the same weights in float32 on the
    card (a profile of one encoder forward in each dtype beside): the encoder output, BF16_TF_STEPS + 1 teacher-forced joint steps
    and the CTC log-probs within PARAKEET_BF16_F32_REL_RMS, those labels
    and durations equal to the float32 run's choice wherever its winner
    leads by more than one bf16 step."""
    cast_s = _cast_bf16(model) + _cast_bf16(ctc)
    _check_bf16_dtypes("parakeet bf16", model, ctc)
    mel4 = run["mel4"]
    wall = {}
    runner = path_runner(launches, wall)
    with torch.no_grad():
        (one,) = runner("parakeet_bf16_decode", lambda: model.decode(mel4[:1]))
        (ctc_one,) = runner("parakeet_bf16_ctc_decode", lambda: ctc.decode(mel4[:1]))
        feats, _ = model.encoder(mel4[:1])
        logp = ctc.decoder(feats)
    for name in ("parakeet_bf16_decode", "parakeet_bf16_ctc_decode"):
        _check_only(name, launches[name], {})
    if feats.dtype != torch.float32 or logp.dtype != torch.float32:
        fail(f"parakeet bf16: encoder output {feats.dtype}, CTC log-probs {logp.dtype}, "
             "not float32 (the JAX package's promotion)")
    labels = _labels(one)
    if not labels or not _labels(ctc_one):
        fail(f"parakeet bf16: {len(labels)} TDT labels, {len(_labels(ctc_one))} CTC labels")
    with torch.no_grad():
        enc1 = median_ms(lambda: model.encoder(mel4[:1]), 3)
        enc4 = median_ms(lambda: model.encoder(mel4), 3)
    t0 = time.perf_counter()
    n = BF16_TF_STEPS + 1
    scale = model._time_scale()
    ref, ref_ctc = _float32_copy(model), _float32_copy(ctc.decoder)
    with torch.no_grad():
        feats_ref, _ = ref.encoder(mel4[:1])
        logp_ref = ref_ctc(feats_ref)
        prof = {name: profile_steps(f"parakeet {name} encoder (batch 1)", fn, 1, KERNEL_GROUPS)
                for name, fn in (("bf16", lambda: model.encoder(mel4[:1])),
                                 ("float32", lambda: ref.encoder(mel4[:1])))}
    bf16 = _parakeet_tf(model, feats, labels, scale, n)
    f32 = _parakeet_tf(ref, feats_ref, labels, scale, n)
    del ref, ref_ctc
    torch.cuda.empty_cache()
    v = PARAKEET_VOCAB
    errs = {"encoder": rel_rms(feats, feats_ref), "joint_logits": rel_rms(bf16, f32),
            "ctc_log_probs": rel_rms(logp, logp_ref)}
    durs = [PARAKEET_DURATIONS.index(int(round(d / scale))) for _, _, d in labels[:n]]
    ties = {"labels": _bf16_tie_check("parakeet bf16 labels", [t for t, _, _ in labels[:n]],
                                      f32[:, :v + 1]),
            "durations": _bf16_tie_check("parakeet bf16 durations", durs, f32[:, v + 1:])}
    out = {"cast_s": cast_s, "encoder_ms_batch1": enc1, "encoder_ms_batch4": enc4,
           "encoder_ms_batch1_f32": f32_info["encoder_ms_batch1"],
           "encoder_ms_batch4_f32": f32_info["encoder_ms_batch4"],
           "decode_s": wall["parakeet_bf16_decode"],
           "decode_s_f32": run["wall"]["parakeet_decode"],
           "labels_per_s": len(labels) / wall["parakeet_bf16_decode"],
           "labels_per_s_f32": len(run["labels"]) / run["wall"]["parakeet_decode"],
           "encoder_profile": _profile_summary(prof),
           "against_f32": {"rel_rms": errs, "tokens": ties}}
    print(f"parakeet bf16 (.to(torch.bfloat16), the CTC head too; the encoder float32 by "
          f"promotion): decode of one window {len(labels)} labels in "
          f"{wall['parakeet_bf16_decode']:.4f} s (float32 {run['wall']['parakeet_decode']:.4f}),"
          f" CTC {len(_labels(ctc_one))} labels; encoder {enc1:.4f} ms at batch 1, {enc4:.4f} "
          f"at batch 4 (float32 {f32_info['encoder_ms_batch1']:.4f}, "
          f"{f32_info['encoder_ms_batch4']:.4f}); launches "
          + json.dumps({k: {n_: c for n_, c in launches[k].items() if c}
                        for k in ("parakeet_bf16_decode", "parakeet_bf16_ctc_decode")})
          + f"; against the same weights in float32 on the card ({time.perf_counter() - t0:.1f}"
          f" s): relative RMS {json.dumps(errs)} (bound {PARAKEET_BF16_F32_REL_RMS}); the "
          f"first {n} labels against the float32 choice {json.dumps(ties)}; on {gpu_line()}",
          flush=True)
    if max(errs.values()) > PARAKEET_BF16_F32_REL_RMS:
        fail(f"parakeet bf16: {json.dumps(errs)} (relative RMS) from float32's")
    return out


def indextts_bf16_runs(model, launches: dict, run: dict, f32_info: dict) -> dict:
    """Phase 12's IndexTTS cast with .to(torch.bfloat16).  The reference
    clip's float32 log-mel takes the conformer, the perceiver and the
    prompt to float32 by promotion (the prefill's latent float32), the GPT
    caches take the mel embedding's dtype (bf16), so the decode steps run
    in bf16, and the vocoder's latents are stacked float32, so BigVGAN runs
    in float32 over its bf16 weights, as in the JAX package: greedy
    generate of INDEXTTS_TOKENS codes launches the float32 dilated_conv1d
    26 times and banded_conv1d 10 times and no bf16 variant, each held to
    its plain version on the path's operands.  Latents a wall second of
    generate and vocoder ms beside the float32 breakdown's; the greedy codes fed, teacher-forced,
    for BF16_TF_STEPS steps through the bf16 model's own start and steps
    and the same weights in float32 on the card: latents and logits within
    BF16_F32_REL_RMS, the codes equal to the float32 argmax wherever its
    winner leads by more than one bf16 step."""
    from mlx_audio_tpu_torch.models.tts.indextts.vocoder import log_mel_spectrogram
    from mlx_audio_tpu_torch.nn import kernels

    cast_s = _cast_bf16(model)
    _check_bf16_dtypes("indextts bf16", model)
    rec, voc_in, step_out = [], [], []
    latents_fn, step_fn = model.generate_latents, model._step
    model.generate_latents = lambda *a, **k: (lambda out: (rec.append(out), out)[1])(
        latents_fn(*a, **k))
    model._step = lambda *a, **k: (lambda out: (step_out.append(out.dtype), out)[1])(
        step_fn(*a, **k))
    hook = model.bigvgan.register_forward_pre_hook(lambda m, a: voc_in.append(a[0].dtype))
    conv_calls, wall = {}, {}
    convs = record_conv_calls(conv_calls)
    runner = path_runner(launches, wall)
    try:
        result = runner("indextts_bf16_generate", lambda: list(model.generate(
            INDEXTTS_TEXT, ref_audio=run["clip"], max_tokens=INDEXTTS_TOKENS,
            temperature=0))[0])
    finally:
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
        hook.remove()
        del model.generate_latents, model._step
    _check_only("indextts_bf16_generate", launches["indextts_bf16_generate"], INDEXTTS_ROUTED)
    _check_indextts("indextts bf16 generate", result, int(np.prod(model.args.bigvgan.upsample_rates)))
    (stream,), (codes,) = rec[0]
    if set(step_out) != {torch.bfloat16} or voc_in != [torch.float32] \
            or stream.dtype != torch.float32:
        fail(f"indextts bf16: decode steps' latents {sorted(map(str, set(step_out)))}, "
             f"vocoder input {voc_in}, latent stream {stream.dtype} (expected bf16, float32 "
             "and float32)")
    conv_err = check_conv_path(conv_calls, convs, "IndexTTS bf16")
    n = INDEXTTS_TOKENS + 1
    with torch.no_grad():
        mel = log_mel_spectrogram(torch.as_tensor(run["clip"], device="cuda"))
        vocoder_ms = median_ms(lambda: model.bigvgan(stream[None], mel), 3)
    t0 = time.perf_counter()
    ref = _float32_copy(model)

    def teacher_forced(m):
        caches, pad_len, prompt_len, latent = m._start([INDEXTTS_TEXT], mel, BF16_TF_STEPS)
        lat = [latent]
        with torch.no_grad():
            for s in range(BF16_TF_STEPS):
                lat.append(m._step(caches, torch.tensor([codes[s]], device="cuda"), s,
                                   pad_len, prompt_len))
            lat = torch.cat(lat)
            return caches[0].k.dtype, lat.float().cpu(), m.mel_head(lat).float().cpu()

    cache_dtype, lat_bf16, logits_bf16 = teacher_forced(model)
    _, lat_f32, logits_f32 = teacher_forced(ref)
    del ref
    torch.cuda.empty_cache()
    if cache_dtype != torch.bfloat16:
        fail(f"indextts bf16: the GPT caches are {cache_dtype}")
    errs = {"latents": rel_rms(lat_bf16, lat_f32), "logits": rel_rms(logits_bf16, logits_f32)}
    ties = _bf16_tie_check("indextts bf16 codes", codes[:BF16_TF_STEPS + 1], logits_f32)
    out = {"cast_s": cast_s, "generate_s": wall["indextts_bf16_generate"],
           "generate_s_f32": f32_info["generate_s"],
           "latents_per_s": n / wall["indextts_bf16_generate"],
           "latents_per_s_f32": n / f32_info["generate_s"],
           "vocoder_ms": vocoder_ms, "vocoder_ms_f32": f32_info["vocoder_ms_batch1"],
           "conv_path_err": conv_err,
           "conv_path_shapes": _per_kernel(conv_calls),
           "against_f32": {"rel_rms": errs, "codes": ties}}
    print(f"indextts bf16 (.to(torch.bfloat16); the conditioning, prompt and vocoder float32 "
          f"by promotion): greedy generate of {n} latents in "
          f"{wall['indextts_bf16_generate']:.3f} s, {out['latents_per_s']:.3f} a wall second "
          f"(float32 {out['latents_per_s_f32']:.3f}), vocoder {vocoder_ms:.4f} ms a call "
          f"(float32 {f32_info['vocoder_ms_batch1']:.4f}); launches "
          f"{json.dumps({k: v for k, v in launches['indextts_bf16_generate'].items() if v})}; "
          f"caches {cache_dtype}, decode-step latents bf16, vocoder input float32; against "
          f"the same weights in float32 on the card ({time.perf_counter() - t0:.1f} s): the "
          f"prefill's and {BF16_TF_STEPS} teacher-forced steps' relative RMS {json.dumps(errs)} "
          f"(bound {BF16_F32_REL_RMS}); codes against the float32 argmax {json.dumps(ties)}; "
          f"on {gpu_line()}", flush=True)
    if max(errs.values()) > BF16_F32_REL_RMS:
        fail(f"indextts bf16: {json.dumps(errs)} (relative RMS) from float32's")
    return out


# ---------------------------------------------------------------------------
# phase 14: the entry points: native checkpoints, the TTS CLI and the server
# ---------------------------------------------------------------------------

# the served texts, one segment each; at SERVE_SPEED the longest gives the
# batch a frame bucket past 1 100 frames, where every dilated K = 7 and 11
# resblock conv of the first upsampled stage (20 samples a frame, d = 5)
# holds the banded route's 4 096 rows, as at phase 4's bench shape
SERVE_TEXTS = [
    "ðə pˈɔɹt sˈɜːvz ˈeɪt ɹɪkwˈɛsts æt wˈʌns, ˈiːtʃ ɪn ɪts ˈoʊn ɹˈoʊ.",
    "ɐ ʃˈɔːɹt wˈʌn.",
    "ðə sˈɛkənd ɹɪkwˈɛst.",
    "hˈɪɹ ɪz ɐ θˈɜːd lˈaɪn ʌv tˈɛkst.",
    "fˈɔːɹ wˈɜːdz ɪn ɐ ɹˈoʊ.",
    "ðə fˈɪfθ ɪz lˈɔŋɡɚ ðæn ðə fˈɔːɹθ, bˌʌt nˈɑːt bˈaɪ mˈʌtʃ.",
    "sˈɪks.",
    "ænd ðə lˈæst wˌʌn klˈoʊzɪz ðə bˈætʃ.",
]
SERVE_SPEED = "1.0"  # the server takes 0.5 to 2.0
SERVE_MAX_BATCH = 8
SERVE_SMALL_BATCH = (5, 6)  # requests, and the batcher's max_batch
SERVE_WINDOW_MS = 1000.0  # the batchers' coalescing window
CLI_TEXT = "həlˈoʊ fɹʌm ðə kˈʌmænd lˈaɪn."
PCM_STEP = 1 / 32768  # one step of the 16-bit wavs the server and the CLI write
# a batch row against its text alone past the first SERVE_HEAD samples, at
# the atol with which tests/test_torch_kokoro.py's test_generate_entry_points
# holds a two-row batch's row: the first source frame's phase may flip
# between batch shapes (a real spectrum's atan2 at +pi or -pi).  At full
# width a bin later in the audio may flip too (seen between the batch of 8
# and its first text alone: source frame 21 738 of 204 001, bin 9, +pi
# against -pi, every other phase within 1e-4 rad; the audio then parts by
# up to 0.10 over about 1 550 samples, relative RMS 3.36e-3), so
# SERVE_FLIP_SAMPLES samples of a row may exceed the atol, by at most
# SERVE_FLIP_MAX_ABS (twice the flip's 0.10; the audio peaks near 1), within
# a relative RMS.  Each row is also read against its neighbour's text alone
# (rows swapped), the reading a mis-batched row would give
SERVE_HEAD, SERVE_ROW_ATOL = 2400, 2e-3
SERVE_FLIP_SAMPLES, SERVE_FLIP_MAX_ABS, SERVE_ROW_REL_RMS = 2400, 0.2, 1e-2


def _pcm(audio: np.ndarray) -> np.ndarray:
    """A float waveform as it reads back from the 16-bit wav that
    ``utils.audio_io.save_audio`` writes."""
    return (np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16) / 32768.0


def kokoro_rows_alone(model, batch: tuple) -> tuple:
    """Each row of a recorded ``synthesize_batch`` call (phoneme strings,
    references, speeds and its outputs) synthesized alone, at that batch's
    phoneme and frame buckets with its batch row's source draws.  Returns
    (audio a row, phoneme bucket, frame bucket)."""
    from mlx_audio_tpu_torch.models.tts.kokoro.model import (
        pick_frame_bucket,
        pick_phoneme_bucket,
    )

    phonemes, refs, speeds, outs = batch
    n_bucket = pick_phoneme_bucket(max(len(model.phonemes_to_ids(p)) + 2 for p in phonemes))
    f_bucket = pick_frame_bucket(max(a.shape[0] for a, _ in outs) // model.SAMPLES_PER_FRAME)
    with torch.no_grad():
        audio = [model.synthesize_batch([p], refs[i:i + 1], speeds=speeds,
                                        buckets=(n_bucket, f_bucket), rows=[i])[0][0]
                 for i, p in enumerate(phonemes)]
    return audio, n_bucket, f_bucket


def _check_same_state(name: str, got, want) -> None:
    """Two models' state_dicts: the same keys, every tensor on the card and
    equal bit for bit, in the same dtype."""
    a, b = got.state_dict(), want.state_dict()
    bad = sorted(set(a) ^ set(b)) or [k for k in b if not (
        a[k].dtype == b[k].dtype and a[k].device.type == "cuda" and torch.equal(a[k], b[k]))]
    if bad:
        fail(f"{name}: {len(bad)} tensors differ from the written model's, e.g. {bad[:3]}")


async def _serve(client, launches: dict, wall: dict, name: str, texts: list,
                 model_dir: str, voice: str) -> list:
    """One /tts request a text, all at once, with the launch counters set to
    0 just before and read just after: the wav file names."""
    import asyncio

    from mlx_audio_tpu_torch.nn import kernels

    async def one(text):
        resp = await client.post("/tts", data={"text": text, "model": model_dir,
                                               "voice": voice, "speed": SERVE_SPEED})
        if resp.status != 200:
            fail(f"/tts: {resp.status} {await resp.text()}")
        return (await resp.json())["filename"]

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    names = await asyncio.gather(*(one(t) for t in texts))
    torch.cuda.synchronize()
    wall[name] = time.perf_counter() - t0
    launches[name] = dict(kernels.LAUNCHES)
    return names


async def _post_stt(client, launches: dict, wall: dict, path: str, model_dir: str) -> dict:
    from aiohttp import FormData

    from mlx_audio_tpu_torch.nn import kernels

    form = FormData()
    form.add_field("model", model_dir)
    with open(path, "rb") as f:
        form.add_field("audio", f.read(), filename="clip.wav")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    resp = await client.post("/stt", data=form)
    if resp.status != 200:
        fail(f"/stt: {resp.status} {await resp.text()}")
    out = await resp.json()
    torch.cuda.synchronize()
    wall["serve_stt"] = time.perf_counter() - t0
    launches["serve_stt"] = dict(kernels.LAUNCHES)
    return out


def entry_point_runs(launches: dict, per_synthesis: dict, voice: str, tmp: Path) -> tuple:
    """Phase 14: the port's entry points as a user calls them, all on the
    card.  Kokoro-82M (seeded random weights at its published config) is
    written with ``utils.loader.save_checkpoint`` into a directory named
    Kokoro-82M and read back with ``load_model`` (every tensor equal bit for
    bit); ``tts.convert.main`` writes a bf16 copy on the card, which loads
    back equal bit for bit to the model cast; ``tts.generate.main`` makes a
    wav of CLI_TEXT from that directory, held to the loaded model's own
    ``generate`` within one PCM step.  Then ``server.create_app`` behind
    aiohttp's test server on loopback: one lone /tts request, 8 concurrent
    ones with different texts through a ``DynamicBatcher(max_batch=8)`` (one
    batch of 8 rows launching ``lstm``, ``dilated_conv1d`` and
    ``banded_conv1d`` as often as one phase 4 synthesis, each kernel held to
    its plain version on the batch's own operands, each row's wav held to
    its text alone at the batch's buckets with its row's draws, past
    SERVE_HEAD within SERVE_ROW_ATOL but for SERVE_FLIP_SAMPLES samples
    within SERVE_FLIP_MAX_ABS, and within SERVE_ROW_REL_RMS), and 5 under
    ``max_batch=6`` (one ``generate_batch`` of exactly 5 rows).  Then
    Whisper-large-v3-turbo (``build_whisper``'s weights, the bundled
    tokenizer) cast to bf16 and
    written as a native checkpoint; /stt of the shortest text's wav through
    the loaded model (the route's defaults: language detection, then every
    temperature of the fallback, which random weights never accept: 7
    encodes of 224-token decodes): every encode launches
    ``dilated_conv1d_bf16`` once (conv1) and no other kernel of ours, and the
    segments' tokens and the text equal the written model's own
    ``generate`` on that file.  The checkpoints are written under ``tmp``;
    returns (the phase's figures, the bf16 Kokoro's and the Whisper's
    checkpoint directories, which phase 15 serves)."""
    import asyncio
    import dataclasses

    from aiohttp.test_utils import TestClient, TestServer

    from mlx_audio_tpu_torch.models.tts.kokoro import Model
    from mlx_audio_tpu_torch.models.tts.kokoro.presets import kokoro_82m_config
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.server import DynamicBatcher, ServerState, create_app
    from mlx_audio_tpu_torch.tts import convert as tts_convert
    from mlx_audio_tpu_torch.tts import generate as tts_generate
    from mlx_audio_tpu_torch.utils.audio_io import load_audio
    from mlx_audio_tpu_torch.utils.loader import load_model, save_checkpoint

    out, wall = {}, {}
    run = path_runner(launches, wall)
    torch.cuda.reset_peak_memory_stats()
    # the native checkpoint
    config = kokoro_82m_config()
    written = Model(config, device="cuda")
    kdir = str(tmp / "Kokoro-82M")
    t0 = time.perf_counter()
    save_checkpoint(written, kdir, {"model_type": "kokoro", **dataclasses.asdict(config)})
    out["kokoro_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_model(kdir, device="cuda")
    torch.cuda.synchronize()
    out["kokoro_load_s"] = time.perf_counter() - t0
    _check_same_state("kokoro native checkpoint", loaded, written)
    # the converter, on the card by default: a bf16 copy that loads back in bf16
    bdir = str(tmp / "Kokoro-82M-bf16")
    t0 = time.perf_counter()
    tts_convert.main(["--hf-path", kdir, "--out-path", bdir, "--dtype", "bfloat16"])
    out["kokoro_convert_s"] = time.perf_counter() - t0
    _check_same_state("kokoro bf16 conversion", load_model(bdir, device="cuda"),
                      written.to(torch.bfloat16))
    del written

    # the TTS CLI
    prefix = str(tmp / "cli")
    run("serve_cli", lambda: tts_generate.main([
        "--model", kdir, "--text", CLI_TEXT, "--voice", voice, "--speed", SERVE_SPEED,
        "--file_prefix", prefix, "--join_audio"]))
    missing = [k for k in KOKORO_KERNELS if launches["serve_cli"][k] == 0]
    if missing:
        fail(f"tts.generate CLI: kernels never launched: {missing}")
    cli = load_audio(prefix + ".wav")
    with torch.no_grad():
        own = np.concatenate([r.audio for r in loaded.generate(
            CLI_TEXT, voice=voice, speed=float(SERVE_SPEED))])
    del loaded
    cli_err = float(np.abs(cli - _pcm(own)).max()) if cli.shape == own.shape else np.inf
    out["cli"] = {"wall_s": wall["serve_cli"], "samples": int(cli.shape[0]),
                  "max_abs_diff": cli_err}
    if not (np.isfinite(cli).all() and cli_err <= PCM_STEP):
        fail(f"tts.generate CLI: {cli.shape} samples, {cli_err:.3e} from the loaded "
             f"model's own generate ({own.shape})")

    # the server: a lone request, a batch of 8, 5 under max_batch 6
    state = ServerState(output_folder=str(tmp / "served"), device="cuda")
    t0 = time.perf_counter()
    model = state.get_tts(kdir)
    out["server_load_s"] = time.perf_counter() - t0
    rows, synth = [], []
    batch_fn, synth_fn = model.generate_batch, model.synthesize_batch
    model.generate_batch = lambda texts, **kw: (rows.append(len(texts)),
                                                batch_fn(texts, **kw))[1]

    def recording_synth(phonemes, refs, speeds=None, **kw):
        outs = synth_fn(phonemes, refs, speeds=speeds, **kw)
        synth.append((phonemes, refs, speeds, outs))
        return outs

    model.synthesize_batch = recording_synth
    # the batch of 8 runs with every conv and lstm launch's operands
    # recorded (the first at each shape), then held to the plain versions
    conv_calls, lstm_calls = {}, {}
    n_small, cap = SERVE_SMALL_BATCH
    rounds = (("serve_tts_lone", SERVE_TEXTS[:1], 1),
              ("serve_tts_batch", SERVE_TEXTS, SERVE_MAX_BATCH),
              ("serve_tts_small", SERVE_TEXTS[:n_small], cap))

    async def serve_tts():
        names, sizes = {}, []
        async with TestClient(TestServer(create_app(state), host="127.0.0.1")) as client:
            for name, texts, max_batch in rounds:
                state.batcher = DynamicBatcher(state, max_batch=max_batch,
                                               max_wait_ms=SERVE_WINDOW_MS)
                recording = name == "serve_tts_batch"
                if recording:
                    convs = record_conv_calls(conv_calls)
                    lstm = record_lstm_calls(lstm_calls)
                try:
                    names[name] = await _serve(client, launches, wall, name, texts,
                                               kdir, voice)
                finally:
                    state.batcher.close()
                    if recording:
                        kernels.banded_conv1d, kernels.dilated_conv1d = convs
                        kernels.lstm = lstm
                sizes.append(state.batcher.last_batch_size)
        state.batcher = None
        return names, sizes, convs, lstm

    names, sizes, convs, lstm = asyncio.run(serve_tts())
    want_rows = [len(texts) for _, texts, _ in rounds]
    if rows != want_rows or sizes != want_rows:
        fail(f"server: generate_batch rows {rows}, last batch sizes {sizes} "
             f"(expected {want_rows}: at most max_batch rows, none padded)")
    got = {k: v for k, v in launches["serve_tts_batch"].items() if v}
    want = {k: v for k, v in per_synthesis.items() if v}
    if got != want:
        fail(f"server batch of {SERVE_MAX_BATCH}: launches {got}, expected phase 4's "
             f"per-synthesis {want}")
    conv_err = check_conv_path(conv_calls, convs, "server batch")
    lstm_err = check_lstm_path(lstm_calls, lstm, "server batch")
    path_shapes = {**_per_kernel(conv_calls), "lstm": len(lstm_calls)}
    del conv_calls, lstm_calls
    torch.cuda.empty_cache()
    # each row against its text alone, at the batch's buckets
    t0 = time.perf_counter()
    model.synthesize_batch = synth_fn
    alone, n_bucket, f_bucket = kokoro_rows_alone(model, synth[1])
    wavs = [load_audio(Path(state.output_folder) / name)
            for name in names["serve_tts_batch"]]

    def against(wav, a):
        n = min(wav.shape[0], a.shape[0])
        got, want = wav[SERVE_HEAD:n], _pcm(a)[SERVE_HEAD:n]
        diff = np.abs(got - want)
        over = diff > SERVE_ROW_ATOL + PCM_STEP
        return {"max_abs": float(diff.max()), "over_atol": int(over.sum()),
                "rel_rms": rel_rms(torch.from_numpy(got), torch.from_numpy(want))}

    row_err = []
    for i, (wav, a) in enumerate(zip(wavs, alone)):
        if wav.shape != a.shape or not np.isfinite(wav).all():
            fail(f"server row {i}: {wav.shape} samples, its text alone {a.shape}")
        row_err.append(against(wav, a))
    swapped = [against(wav, alone[(i + 1) % len(alone)]) for i, wav in enumerate(wavs)]
    if any(e["over_atol"] > SERVE_FLIP_SAMPLES or e["max_abs"] > SERVE_FLIP_MAX_ABS
           or e["rel_rms"] > SERVE_ROW_REL_RMS for e in row_err):
        fail(f"server rows against their texts alone past sample {SERVE_HEAD}: "
             f"{row_err} (atol {SERVE_ROW_ATOL} but for {SERVE_FLIP_SAMPLES} samples "
             f"within {SERVE_FLIP_MAX_ABS}, relative RMS {SERVE_ROW_REL_RMS})")
    print(f"server rows against their texts alone past sample {SERVE_HEAD}: relative "
          f"RMS {max(e['rel_rms'] for e in row_err):.3e} at most, max_abs "
          f"{max(e['max_abs'] for e in row_err):.3e} (bounds {SERVE_ROW_REL_RMS}, "
          f"{SERVE_FLIP_MAX_ABS}); rows swapped (each against the next text alone): "
          f"relative RMS {min(e['rel_rms'] for e in swapped):.3e} at least, max_abs "
          f"{min(e['max_abs'] for e in swapped):.3e} at least", flush=True)
    audio_s = sum(a.shape[0] for a in alone) / model.sample_rate
    out["tts"] = {
        "lone_wall_s": wall["serve_tts_lone"], "batch_wall_s": wall["serve_tts_batch"],
        "small_batch_wall_s": wall["serve_tts_small"], "batch_audio_s": audio_s,
        "batch_audio_s_per_s": audio_s / wall["serve_tts_batch"],
        "lone_audio_s": alone[0].shape[0] / model.sample_rate,
        "phoneme_bucket": n_bucket, "frame_bucket": f_bucket,
        "frames": [a.shape[0] // 600 for a in alone],
        "rows_past_head": row_err, "rows_swapped": swapped,
        "conv_path_err": conv_err, "lstm_path_err": lstm_err, "path_shapes": path_shapes,
        "alone_check_s": time.perf_counter() - t0}
    stt_wav = str(Path(state.output_folder)
                  / names["serve_tts_batch"][int(np.argmin([a.size for a in alone]))])
    del model, alone, wavs, synth
    state.tts_model = None
    torch.cuda.empty_cache()

    # Whisper-large-v3-turbo in bf16 through /stt
    wmodel, _ = build_whisper()
    del wmodel._tokenizer  # the bundled tokenizer, as a loaded model has
    wmodel.to(torch.bfloat16)
    wdir = str(tmp / "whisper-large-v3-turbo")
    t0 = time.perf_counter()
    save_checkpoint(wmodel, wdir, WHISPER_DIMS)
    out["whisper_save_s"] = time.perf_counter() - t0
    out["whisper_checkpoint_gb"] = (Path(wdir) / "weights.safetensors").stat().st_size / 1e9
    t0 = time.perf_counter()
    served = state.get_stt(wdir)
    torch.cuda.synchronize()
    out["whisper_load_s"] = time.perf_counter() - t0
    _check_same_state("whisper bf16 native checkpoint", served, wmodel)
    encodes = {"n": 0}
    undo = _count_calls(served.encoder, encodes)

    async def serve_stt():
        async with TestClient(TestServer(create_app(state), host="127.0.0.1")) as client:
            return await _post_stt(client, launches, wall, stt_wav, wdir)

    try:
        resp = asyncio.run(serve_stt())
    finally:
        undo()
    _check_only("serve_stt", launches["serve_stt"], {"dilated_conv1d_bf16": encodes["n"]})
    with torch.no_grad():
        own = wmodel.generate(stt_wav)
    got_tokens = [s["tokens"] for s in resp["segments"]]
    own_tokens = [s["tokens"] for s in own.segments]
    if not got_tokens or got_tokens != own_tokens or resp["text"] != own.text:
        fail(f"/stt: segment tokens {[len(t) for t in got_tokens]} differ from the "
             f"written model's own generate {[len(t) for t in own_tokens]}")
    out["stt"] = {"wall_s": wall["serve_stt"], "encodes": encodes["n"],
                  "segments": len(got_tokens),
                  "tokens": sum(len(t) for t in got_tokens), "language": resp["language"],
                  "audio_s": len(load_audio(stt_wav)) / 24_000}
    del wmodel, served
    state.stt_model = None
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    return out, {"kokoro_bf16": bdir, "whisper": wdir}


WORKER_WAIT_S = 1200  # the longest an early-started worker waits for its go file
WORKER_READY_S = 180  # the longest phase 13's bench waits for the workers' set-up


def start_worker(call: str, args: list, go: Path, log: Path) -> tuple:
    """A fresh process that imports torch, makes its CUDA context, imports
    this script and runs ``chip_smoke.<call>(go, ready, *args)`` (string
    arguments).  The call does its set-up, then ``hold(go, ready)``: it
    creates the file ``ready`` and waits for the file ``go`` before its
    timed work, so its start-up runs where the caller starts it and its
    timed work runs alone.  Its output goes to ``log``; it is killed at exit
    if still running.  Returns (the process, ``ready``)."""
    import atexit

    ready = log.with_suffix(".ready")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", "import sys; import torch; torch.cuda.init(); "
             "sys.path.insert(0, sys.argv[1]); import chip_smoke; "
             "getattr(chip_smoke, sys.argv[2])(*sys.argv[3:])",
             str(ROOT), call, str(go), str(ready), *map(str, args)],
            stdout=out, stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, ready


def hold(go: str, ready: str) -> None:
    """A worker's end of set-up: create ``ready``, then return once the
    file ``go`` exists (raise after WORKER_WAIT_S)."""
    Path(ready).touch()
    t0 = time.perf_counter()
    while not Path(go).exists():
        if time.perf_counter() - t0 > WORKER_WAIT_S:
            raise TimeoutError(f"no {go} in {WORKER_WAIT_S} s")
        time.sleep(0.05)


def wait_ready(workers: list, timeout: float) -> float:
    """Wait until every (process, ready file, log) of ``workers`` has set
    up; fail with a log's tail if one exits first or the wait outlasts
    ``timeout`` s.  Returns the seconds waited."""
    t0 = time.perf_counter()
    for proc, ready, log in workers:
        while not ready.exists():
            if proc.poll() is not None:
                fail(f"a worker exited during its set-up: {Path(log).read_text()[-3000:]}")
            if time.perf_counter() - t0 > timeout:
                fail(f"a worker did not set up in {timeout} s: {Path(log).read_text()[-3000:]}")
            time.sleep(0.05)
    return time.perf_counter() - t0


def join_workers(name: str, procs: list, go: Path, logs: list, timeout: float) -> None:
    """Release early-started workers (create ``go``) and wait for each
    within ``timeout`` s; fail with a log's tail if one fails or runs over
    (every worker is then killed)."""
    go.touch()
    t0 = time.perf_counter()
    for proc in procs:
        try:
            proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            fail(f"{name}: no end in {timeout} s")
    for proc, log in zip(procs, logs):
        if proc.returncode:
            fail(f"{name}: a worker failed: {Path(log).read_text()[-3000:]}")


# Kokoro's prewarm in a fresh process: the grid up to PREWARM_MAX_PHONEMES,
# then a text of a length the grid did not run (63 ids: the 64 bucket) made
# twice; the duration head held at the trained rate (as in phase 15), so the
# text's frames stay inside the warmed frame buckets
PREWARM_MAX_PHONEMES = 128
PREWARM_TEXT = "ðə pɹˈiːwɔːɹm wɔːɹmz ˈɛvɹi bˈʌkɪt bɪfˈɔːɹ ðə fˈɜːst ɹɪkwˈɛst."
PREWARM_TIMEOUT_S = 300


def kokoro_prewarm_worker(go: str, ready: str, kdir: str, voice: str, out: str) -> None:
    """A fresh process (``start_worker``, released by
    ``kokoro_prewarm_runs``): the port's modules imported before its
    release; then phase 14's Kokoro-82M checkpoint loaded,
    ``Model.prewarm(max_phonemes=PREWARM_MAX_PHONEMES)``, then
    ``synthesize`` of PREWARM_TEXT twice; for each step its wall seconds,
    the kernel libraries it loaded (``build.load``'s first load in this
    process) and its kernel launches, to ``out``."""
    from mlx_audio_tpu_torch import build
    from mlx_audio_tpu_torch.models.tts.kokoro.model import (
        pick_frame_bucket,
        pick_phoneme_bucket,
    )
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.utils.loader import load_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hold(go, ready)
    t0 = time.perf_counter()
    model = load_model(kdir, device="cuda")
    with torch.no_grad():
        model.predictor.duration_proj.weight.zero_()
        model.predictor.duration_proj.bias.fill_(STS_DURATION_BIAS)
    torch.cuda.synchronize()
    rec = {"load_s": time.perf_counter() - t0}

    def step(name, fn):
        torch.cuda.synchronize()
        kernels.reset_launches()
        libs = len(build._loaded)
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        rec[name] = {"s": time.perf_counter() - t0,
                     "libraries_loaded": len(build._loaded) - libs,
                     "launches": {k: kernels.LAUNCHES[k] for k in KOKORO_KERNELS}}
        return result

    issued = step("prewarm", lambda: model.prewarm(max_phonemes=PREWARM_MAX_PHONEMES))
    rec["prewarm"]["issued"] = issued
    ref = np.load(voice)[len(PREWARM_TEXT) - 1].reshape(-1)
    with torch.no_grad():
        for name in ("first_synthesize", "second_synthesize"):
            audio, dur = step(name, lambda: model.synthesize(PREWARM_TEXT, ref))
            rec[name].update(samples=int(audio.shape[0]), finite=bool(np.isfinite(audio).all()))
    n_ids = len(model.phonemes_to_ids(PREWARM_TEXT)) + 2
    rec["buckets"] = [pick_phoneme_bucket(n_ids), pick_frame_bucket(int(dur.sum()))]
    with open(out, "w") as f:
        json.dump(rec, f)


def prewarm_grid_calls(max_phonemes: int, frames_per_phoneme: int = 3) -> int:
    """The stage calls of one ``Model.prewarm`` at batch 1: a duration call
    a phoneme bucket up to max_phonemes's, a synthesis call a frame bucket
    up to frames_per_phoneme frames a phoneme of that bucket."""
    from mlx_audio_tpu_torch.models.tts.kokoro.model import (
        FRAME_BUCKET_STEP,
        PHONEME_BUCKETS,
        pick_frame_bucket,
        pick_phoneme_bucket,
    )

    top = pick_phoneme_bucket(max_phonemes)
    return sum(1 + pick_frame_bucket(p * frames_per_phoneme) // FRAME_BUCKET_STEP
               for p in PHONEME_BUCKETS if p <= top)


def start_prewarm_worker(kdir: str, voice: str, tmp: Path) -> tuple:
    """Start phase 14's prewarm process (at phase 13's start);
    it sets up, then waits for ``kokoro_prewarm_runs`` to release it once
    the checkpoint is written and the entry points are done."""
    paths = {k: tmp / f"prewarm.{k}" for k in ("go", "log", "json")}
    proc, paths["ready"] = start_worker("kokoro_prewarm_worker", [kdir, voice, paths["json"]],
                                        paths["go"], paths["log"])
    return proc, paths


def kokoro_prewarm_runs(launches: dict, worker: tuple) -> dict:
    """Phase 14's prewarm step: release ``kokoro_prewarm_worker`` (started
    and set up early, ``start_prewarm_worker``) and read it.  Its prewarm must issue
    the grid's stage calls and launch every Kokoro kernel; its first
    ``synthesize`` after it must load no kernel library, launch every
    Kokoro kernel and run at buckets the grid ran.  Prints each step's
    seconds, libraries loaded and launches."""
    from mlx_audio_tpu_torch.models.tts.kokoro.model import pick_frame_bucket, pick_phoneme_bucket

    proc, paths = worker
    t0 = time.perf_counter()
    join_workers("kokoro prewarm", [proc], paths["go"], [paths["log"]], PREWARM_TIMEOUT_S)
    warm = json.loads(paths["json"].read_text())
    warm["released_s"] = time.perf_counter() - t0
    want = prewarm_grid_calls(PREWARM_MAX_PHONEMES)
    top = pick_phoneme_bucket(PREWARM_MAX_PHONEMES)
    p_bucket, f_bucket = warm["buckets"]
    first = warm["first_synthesize"]
    if warm["prewarm"]["issued"] != want or not all(warm["prewarm"]["launches"].values()):
        fail(f"kokoro prewarm: {warm['prewarm']} (expected {want} stage calls, every "
             "Kokoro kernel launched)")
    if first["libraries_loaded"] or not all(first["launches"].values()) or not (
            p_bucket <= top and f_bucket <= pick_frame_bucket(3 * p_bucket)) or not (
            first["finite"] and first["samples"]):
        fail(f"kokoro prewarm: the first synthesize after it {first} at buckets "
             f"{warm['buckets']} (no kernel library may load; buckets within the grid)")
    for name in ("prewarm", "first_synthesize", "second_synthesize"):
        launches[f"kokoro_prewarm_{name}"] = warm[name]["launches"]
    print(f"phase 14 prewarm: Kokoro-82M prewarm(max_phonemes={PREWARM_MAX_PHONEMES}) in a "
          f"fresh process: {warm['prewarm']['issued']} stage calls in "
          f"{warm['prewarm']['s']:.3f} s, {warm['prewarm']['libraries_loaded']} kernel "
          f"libraries loaded, launches {json.dumps(warm['prewarm']['launches'])}; then a "
          f"novel length ({p_bucket} phoneme, {f_bucket} frame bucket): first synthesize "
          f"{first['s']:.4f} s ({first['libraries_loaded']} libraries loaded, launches "
          f"{json.dumps(first['launches'])}), second {warm['second_synthesize']['s']:.4f} s"
          f"; the model's load {warm['load_s']:.3f} s, the process's work after its release "
          f"{warm['released_s']:.1f} s; on {gpu_line()}", flush=True)
    return warm


# ---------------------------------------------------------------------------
# phase 15: one speech-to-speech session: /ws/sts, --prewarm and WebRTC
# ---------------------------------------------------------------------------

# Qwen2.5-0.5B-Instruct's config.json (the published widths; the chat LM
# caps its context at 8 192 positions, as the JAX package's does)
QWEN25_05B_CONFIG = {"model_type": "qwen2", "hidden_size": 896, "intermediate_size": 4864,
                     "num_attention_heads": 14, "num_hidden_layers": 24,
                     "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
                     "rope_theta": 1_000_000.0, "tie_word_embeddings": True,
                     "vocab_size": 151_936, "max_position_embeddings": 32_768}
STS_TURNS = 2  # /ws/sts turns; then one through the WebRTC bridge
STS_UTT_SECONDS = 2.0  # each turn's utterance
STS_FRAME_SECONDS = 0.15  # the client's silence frames, sent in real time
STS_ENDPOINT_SECONDS = 1.2  # the client's endpointing window before "flush"
STS_CHAT_TOKENS = 32  # the chat LM's max_tokens
STS_BRIDGE_RATE = 48_000  # the WebRTC bridge's peer clock
STS_BRIDGE_FRAME = 960  # 20 ms at 48 kHz, as a peer's track delivers them
# a random duration head predicts about 25 frames a phoneme where trained
# Kokoro sits near 2.5: held at that rate (weight 0, bias logit(2.5 / 50))
STS_DURATION_BIAS = float(np.log(0.05 / 0.95))


class STSChatTokenizer:
    """A chat template without tokenizer files: a character's id is 3 + its
    code point mod 800, the prompt's last 512 kept; a reply decodes to
    words with a period every sixth, so it has sentences to stream."""

    eos_token_id = 2

    def apply_chat_template(self, messages, tokenize=True, add_generation_prompt=True):
        return [3 + (ord(c) % 800) for c in " ".join(m["content"] for m in messages)][-512:]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{i}." if (j + 1) % 6 == 0 else f"w{i}" for j, i in enumerate(ids))

    def convert_tokens_to_ids(self, tok):
        return None


class STSWhisper:
    """Whisper's generate with the decode options of a latency benchmark
    (greedy, English, no no-speech threshold): random weights would
    otherwise fall back through every temperature.  Counts its calls and
    their wall seconds."""

    def __init__(self, model, wall: dict):
        self.model, self.wall, self.texts = model, wall, []

    def generate(self, audio, **kw):
        t0 = time.perf_counter()
        out = self.model.generate(np.asarray(audio, dtype=np.float32), temperature=0.0,
                                  language="en", condition_on_previous_text=False,
                                  no_speech_threshold=None)
        self.wall["stt_s"] += time.perf_counter() - t0
        self.wall["stt_calls"] += 1
        self.texts.append(out.text.strip())
        return out


class STSTimedChat:
    """The chat LM as the pipeline calls it, its calls' wall seconds added
    up: a streamed turn (``respond_stream``, /ws/sts) or a whole one (the
    call, the WebRTC bridge's ``process_turn``)."""

    def __init__(self, chat, wall: dict):
        self.chat, self.wall = chat, wall

    def __call__(self, text, history=None):
        t0 = time.perf_counter()
        out = self.chat.respond(text, history=history)
        self.wall["chat_s"] += time.perf_counter() - t0
        return out

    def respond_stream(self, text, history=None):
        t0 = time.perf_counter()
        yield from self.chat.respond_stream(text, history=history)
        self.wall["chat_s"] += time.perf_counter() - t0

    def prewarm(self):
        return self.chat.prewarm()


def build_sts_chat(root: Path):
    """The chat LM at Qwen2.5-0.5B-Instruct's published widths with seeded
    random weights, written in bf16 as an HF-layout directory and read back
    through ``ChatLM.from_pretrained`` on the card (bf16 but the RoPE
    tables; every tensor must equal the written one)."""
    from safetensors.numpy import save_file

    from mlx_audio_tpu_torch.convert import params_to_jax
    from mlx_audio_tpu_torch.models.base import init_weights
    from mlx_audio_tpu_torch.models.lm.causal import LlamaForCausalLM
    from mlx_audio_tpu_torch.models.lm.chat import ChatLM, llama_config_from_hf
    from mlx_audio_tpu_torch.models.lm.llama import cast_lm

    t0 = time.perf_counter()
    with torch.device("cuda"):
        written = LlamaForCausalLM(llama_config_from_hf(QWEN25_05B_CONFIG))
    init_weights(written, torch.Generator(device="cuda").manual_seed(0))
    cast_lm(written, torch.bfloat16)
    path = root / "Qwen2.5-0.5B-Instruct"
    path.mkdir()
    state = {k: v for k, v in written.state_dict().items() if "rope_" not in k}
    save_file(params_to_jax(state, written), str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(QWEN25_05B_CONFIG))
    t1 = time.perf_counter()
    chat = ChatLM.from_pretrained(str(path), dtype="bfloat16", tokenizer=STSChatTokenizer(),
                                  device="cuda", max_tokens=STS_CHAT_TOKENS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _check_same_state("chat LM checkpoint", chat.model, written)
    got = {k: t.dtype for k, t in chat.model.state_dict().items()}
    if {got.pop("model.rope_cos"), got.pop("model.rope_sin")} != {torch.float32} or set(
            got.values()) != {torch.bfloat16}:
        fail(f"chat LM: dtypes {set(got.values())} after from_pretrained(dtype=bfloat16)")
    n = sum(t.numel() for t in state.values())
    print(f"chat LM (Qwen2.5-0.5B-Instruct widths, {n / 1e6:.1f} M parameters, bf16) "
          f"written in {t1 - t0:.1f} s ({(path / 'model.safetensors').stat().st_size / 1e9:.3f}"
          f" GB), loaded with ChatLM.from_pretrained in {t2 - t1:.1f} s", flush=True)
    del written
    torch.cuda.empty_cache()
    return chat


def sts_chat_against_float32(chat, ids) -> dict:
    """The bf16 chat LM's greedy tokens from ``ids`` and its logits over
    the prefill and BF16_TF_STEPS teacher-forced steps, against the same
    weights upcast to float32 on the card: logits within
    BF16_LM_CPU_REL_RMS, tokens equal to float32's argmax but at a
    one-bf16-step near-tie."""
    import copy

    from mlx_audio_tpu_torch.models.lm import causal
    from mlx_audio_tpu_torch.models.lm.llama import cast_lm

    ids = np.asarray(ids, dtype=np.int64)
    toks = [int(t) for c in causal.generate_tokens(chat.model, ids,
                                                   max_tokens=BF16_TF_STEPS + 1,
                                                   temperature=0.0) for t in c]

    def logits(lm):
        dev = lm.model.rope_cos.device
        caches, pad_len, prompt, _, _ = causal._start(lm, [ids], BF16_TF_STEPS + 1, None,
                                                      1.0, 1)
        out = [causal._prefill(lm, caches, pad_len, prompt)]
        with torch.no_grad():
            for t in toks[:-1]:
                h, _ = lm.model.step(caches, torch.tensor([[t]], device=dev), pad_len)
                out.append(lm.logits(h[:, -1]).float())
        return torch.cat([o.cpu() for o in out])

    card = logits(chat.model)
    f32 = cast_lm(copy.deepcopy(chat.model), torch.float32)
    ref = logits(f32)
    del f32
    torch.cuda.empty_cache()
    err = rel_rms(card, ref)
    ties = _bf16_tie_check("sts chat bf16 greedy tokens", toks, ref)
    print(f"sts chat LM bf16 against the same weights in float32 on the card: the "
          f"prefill's and {BF16_TF_STEPS} teacher-forced steps' logits {tuple(card.shape)}, "
          f"relative RMS {err:.3e} (bound {BF16_LM_CPU_REL_RMS}); greedy tokens against "
          f"float32's argmax {json.dumps(ties)}", flush=True)
    if err > BF16_LM_CPU_REL_RMS:
        fail(f"sts chat LM: bf16 logits {err:.3e} (relative RMS) from float32's")
    return {"rel_rms": err, "tokens": ties}


async def _sts_ws_turns(client, utt: np.ndarray, turns: int, on_turn) -> list:
    """Drive /ws/sts as a browser client does: each turn the utterance, the
    endpointing window's silence frames in real time, then "flush"; a reader
    takes every message and the first audio byte's time.  ``on_turn(i,
    "start" | "end")`` brackets each turn.  Returns per turn the messages
    and the times."""
    import asyncio

    out = []
    sil = np.zeros(int(STS_FRAME_SECONDS * 16_000), dtype=np.float32)
    async with client.ws_connect("/ws/sts") as ws:
        for i in range(turns):
            got = {"t_audio": None, "messages": []}

            async def reader():
                while True:
                    msg = await ws.receive(timeout=600)
                    if msg.type.name == "BINARY":
                        got["t_audio"] = got["t_audio"] or time.perf_counter()
                        got["messages"].append(("bytes", bytes(msg.data)))
                    elif msg.type.name == "TEXT":
                        data = json.loads(msg.data)
                        got["messages"].append(("json", data))
                        if "transcript" in data:
                            return
                    else:
                        fail(f"/ws/sts turn {i}: message {msg.type.name}")

            on_turn(i, "start")
            task = asyncio.create_task(reader())
            await ws.send_bytes(utt.tobytes())
            t_speech_end = time.perf_counter()
            for _ in range(round(STS_ENDPOINT_SECONDS / STS_FRAME_SECONDS)):
                await ws.send_bytes(sil.tobytes())
                await asyncio.sleep(STS_FRAME_SECONDS)
            await ws.send_str("flush")
            t_flush = time.perf_counter()
            await task
            on_turn(i, "end")
            t_audio = got["t_audio"] or float("nan")
            out.append({"messages": got["messages"],
                        "speech_end_to_audio_ms": (t_audio - t_speech_end) * 1e3,
                        "flush_to_audio_ms": (t_audio - t_flush) * 1e3})
    return out


async def _sts_bridge_turn(pipeline, utt: np.ndarray) -> dict:
    """One turn through the WebRTC bridge at 48 kHz: the utterance and then
    silence in 20 ms frames, as a peer's track delivers them, until the
    endpointer closes the utterance; the reply pulled at the peer clock."""
    from mlx_audio_tpu_torch.sts.webrtc import PcmAssistantBridge
    from mlx_audio_tpu_torch.utils.audio_io import resample_audio

    texts = []
    bridge = PcmAssistantBridge(pipeline, in_rate=STS_BRIDGE_RATE, out_rate=STS_BRIDGE_RATE,
                                on_transcript=texts.append)
    pcm = resample_audio(utt, 16_000, STS_BRIDGE_RATE).astype(np.float32)
    t0 = time.perf_counter()
    for i in range(0, len(pcm), STS_BRIDGE_FRAME):
        await bridge.feed(pcm[i:i + STS_BRIDGE_FRAME])
    t_speech_end = time.perf_counter()
    silence = np.zeros(STS_BRIDGE_FRAME, dtype=np.float32)
    frames = 0
    while bridge._turn_task is None:
        await bridge.feed(silence)
        frames += 1
        if frames * 0.02 > 10 * pipeline.config.silence_duration:
            fail("sts bridge: the endpointer never closed the utterance")
    await bridge._turn_task
    t_done = time.perf_counter()
    audio = await bridge.pull(bridge.pending_samples)
    return {"texts": texts, "audio": audio, "silence_frames": frames,
            "speech_end_to_reply_s": t_done - t_speech_end, "wall_s": t_done - t0}


def sts_session_runs(launches: dict, ckpts: dict, voice: str, tmp: Path) -> dict:
    """Phase 15: one speech-to-speech session as ``scripts/bench_sts.py``
    drives it, through the port's server on the card.  Whisper-large-v3-
    turbo from phase 14's bf16 checkpoint (behind STSWhisper), the chat LM
    at Qwen2.5-0.5B-Instruct's widths in bf16 (``build_sts_chat``), Kokoro-
    82M from phase 14's bf16 conversion with its duration head at the
    trained rate; the server's ``prewarm``, then STS_TURNS turns through
    /ws/sts and one through the WebRTC bridge.

    Every turn must give its transcript, then an audio chunk for each
    sentence of the reply, then the final JSON with a non-empty reply.
    Each chunk must equal ``tts.generate`` of its sentence called directly
    on the card, bit for bit; each reply a direct ``ChatLM.respond_stream``
    (the bridge's ``respond``) with the same seed and history.  Every conv
    and lstm launch of the session is recorded and held to its plain
    version on its operands; each turn's launches are read with the
    counters set to 0 just before it, and each must include the Whisper
    encode's ``dilated_conv1d_bf16`` (one an STT call) and every kernel a
    direct synthesis launches."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    import mlx_audio_tpu_torch.server as server
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.sts import voice_pipeline as vp
    from mlx_audio_tpu_torch.sts.voice_pipeline import split_sentences
    from mlx_audio_tpu_torch.utils.audio_io import resample_audio

    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    state = server.ServerState(output_folder=str(tmp / "sts"), device="cuda")
    wall = {"stt_s": 0.0, "stt_calls": 0, "chat_s": 0.0, "tts_s": 0.0, "tts_calls": 0}
    stt = STSWhisper(state.get_stt(ckpts["whisper"]), wall)
    state.stt_model = stt
    tts = state.get_tts(ckpts["kokoro_bf16"])
    with torch.no_grad():
        tts.predictor.duration_proj.weight.zero_()
        tts.predictor.duration_proj.bias.fill_(STS_DURATION_BIAS)
    chat = build_sts_chat(tmp)
    build_s = time.perf_counter() - t_build
    state.sts_options = {"stt_model": ckpts["whisper"], "tts_model": ckpts["kokoro_bf16"],
                         "tts_voice": voice}
    opts = dict(voice=voice, speed=1.0, lang_code="a")

    # a direct synthesis's launches: every kernel a turn's TTS launches
    kernels.reset_launches()
    with torch.no_grad():
        list(tts.generate("ðɪs ɪz ɐ tˈɛst.", **opts))
    per_synthesis = {k: v for k, v in kernels.LAUNCHES.items() if v}

    # the TTS timed and recorded; the pipelines take the chat LM, timed
    tts_generate = tts.generate
    spoken = []

    def timed_generate(text, **kw):
        t0 = time.perf_counter()
        with torch.no_grad():
            out = list(tts_generate(text, **kw))
        wall["tts_s"] += time.perf_counter() - t0
        wall["tts_calls"] += 1
        spoken.append((text, kw, [r.audio for r in out]))
        yield from out

    tts.generate = timed_generate
    init_models = vp.VoicePipeline.init_models
    timed_chat = STSTimedChat(chat, wall)

    def with_chat(self):
        self._llm = self._llm or timed_chat
        return init_models(self)

    vp.VoicePipeline.init_models = with_chat
    conv_calls, lstm_calls = {}, {}
    convs = record_conv_calls(conv_calls)
    lstm = record_lstm_calls(lstm_calls)
    t = np.arange(int(STS_UTT_SECONDS * 16_000)) / 16_000
    rng = np.random.default_rng(0)
    utt = (0.1 * np.sin(2 * np.pi * 220 * t)
           + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
    turns_wall, turn_marks = [], {}

    def on_turn(i, mark):
        torch.cuda.synchronize()
        if mark == "start":
            kernels.reset_launches()
            turn_marks[i] = (dict(wall), len(spoken))
            return
        launches[f"sts_turn_{i}"] = dict(kernels.LAUNCHES)
        before, n_spoken = turn_marks[i]
        turns_wall.append({**{k: wall[k] - before[k] for k in wall},
                           "sentences": len(spoken) - n_spoken})

    try:
        t0 = time.perf_counter()
        issued = server.prewarm(state)
        torch.cuda.synchronize()
        prewarm_s = time.perf_counter() - t0
        want = prewarm_grid_calls(128) + 1 + len(vp.VoicePipeline.PREWARM_STT_SECONDS)
        if issued != want:
            fail(f"--prewarm: {issued} calls, not {want} (Kokoro's stage grid at 128 "
                 "phonemes, a chat turn, the STT lengths)")
        spoken.clear()

        async def session():
            async with TestClient(TestServer(server.create_app(state),
                                             host="127.0.0.1")) as client:
                return await _sts_ws_turns(client, utt, STS_TURNS, on_turn)

        turns = asyncio.run(session())
        n_ws_spoken = len(spoken)
        pipeline = vp.VoicePipeline(vp.VoicePipelineConfig(**state.sts_options),
                                    server_state=state)
        on_turn(STS_TURNS, "start")
        bridge = asyncio.run(_sts_bridge_turn(pipeline, utt))
        on_turn(STS_TURNS, "end")
    finally:
        vp.VoicePipeline.init_models = init_models
        kernels.banded_conv1d, kernels.dilated_conv1d = convs
        kernels.lstm = lstm
        tts.generate = tts_generate

    # each /ws/sts turn: transcript, a chunk a sentence, the final reply
    history, rows, k = [], [], 0
    for i, turn in enumerate(turns):
        msgs = turn["messages"]
        kinds = [m[0] for m in msgs]
        header, final = msgs[0][1], msgs[-1][1]
        if not (kinds[0] == "json" and header.get("user_transcript")
                and header.get("sample_rate") == tts.sample_rate):
            fail(f"/ws/sts turn {i}: the first message is {msgs[0][1] if msgs else None}, "
                 "not the user's transcript (an empty transcript ends the turn before "
                 "the chat LM)")
        reply = final.get("transcript") if kinds[-1] == "json" else None
        chunks = [m[1] for m in msgs[1:-1]]
        if not reply or set(kinds[1:-1]) != {"bytes"}:
            fail(f"/ws/sts turn {i}: messages {kinds}, final {final}")
        sents, rest = split_sentences(reply)
        sents += [rest] if rest else []
        said = spoken[k:k + turns_wall[i]["sentences"]]
        k += len(said)
        if [s for s, _, _ in said] != sents or len(chunks) != sum(len(a) for _, _, a in said):
            fail(f"/ws/sts turn {i}: {len(chunks)} chunks for sentences "
                 f"{[s for s, _, _ in said]}, the reply's {sents}")
        want = list(chat.respond_stream(header["user_transcript"], history=list(history)))[-1]
        if reply != want:
            fail(f"/ws/sts turn {i}: the reply {reply!r} differs from a direct "
                 f"respond_stream's {want!r}")
        history += [{"role": "user", "content": header["user_transcript"]},
                     {"role": "assistant", "content": reply}]
        rows.append((chunks, said))
    if k != n_ws_spoken:
        fail(f"/ws/sts: {n_ws_spoken} sentences spoken, {k} in the turns' replies")

    # every chunk against tts.generate of its sentence, called directly
    exact, err = True, 0.0
    for chunks, said in rows:
        direct = []
        for text, kw, _ in said:
            with torch.no_grad():
                direct += [np.asarray(r.audio, dtype=np.float32).reshape(-1)
                           for r in tts_generate(text, **kw)]
        for got, want in zip(chunks, direct):
            got = np.frombuffer(got, dtype=np.float32)
            same = got.shape == want.shape and got.tobytes() == want.tobytes()
            exact = exact and same
            if got.shape != want.shape:
                fail(f"/ws/sts: a chunk of {got.shape[0]} samples, its direct generate "
                     f"{want.shape[0]}")
            err = max(err, float(np.abs(got - want).max()))
    if not exact:
        print(f"sts: the chunks are not bit for bit a direct generate's (max abs "
              f"{err:.3e}); held to phase 14's row bounds instead", flush=True)
        if err > SERVE_FLIP_MAX_ABS:
            fail(f"/ws/sts: a chunk differs from its direct generate by {err:.3e}")

    # the bridge turn: the reply of a direct respond to its transcript, and
    # the audio of a direct generate of that, resampled to the peer clock
    text = stt.texts[-1] if stt.texts else ""
    said = spoken[n_ws_spoken:]
    if not text or len(said) != 1 or bridge["texts"] != [said[0][0]]:
        fail(f"sts bridge: transcript {text!r}, replies {bridge['texts']}, "
             f"{len(said)} syntheses")
    reply = chat.respond(text, history=[])
    if said[0][0] != reply:
        fail(f"sts bridge: the reply spoken {said[0][0]!r} differs from a direct "
             f"respond's {reply!r}")
    with torch.no_grad():
        direct = np.concatenate([r.audio for r in tts_generate(reply, **said[0][1])])
    want = resample_audio(np.asarray(direct, dtype=np.float32), tts.sample_rate,
                          STS_BRIDGE_RATE).astype(np.float32)
    if bridge["audio"].shape != want.shape:
        fail(f"sts bridge: {bridge['audio'].shape} samples pulled, a direct generate "
             f"resampled {want.shape}")
    bridge_err = float(np.abs(bridge["audio"] - want).max())
    if bridge_err > (0.0 if exact else SERVE_FLIP_MAX_ABS):
        fail(f"sts bridge: the pulled reply differs from a direct generate by {bridge_err:.3e}")

    # the launches of each turn
    stray = ("quantized_matmul", "quantized_matmul_bf16", "depth_draft", *PROBE_KERNELS)
    for i in range(STS_TURNS + 1):
        lc = launches[f"sts_turn_{i}"]
        need = {"dilated_conv1d_bf16": turns_wall[i]["stt_calls"] + per_synthesis.get(
            "dilated_conv1d_bf16", 0) * turns_wall[i]["tts_calls"]}
        missing = [k2 for k2 in per_synthesis if lc[k2] == 0]
        if turns_wall[i]["stt_calls"] != 1:
            fail(f"sts turn {i}: {turns_wall[i]['stt_calls']} STT calls, not the one "
                 "speculative transcription")
        if missing or lc["dilated_conv1d_bf16"] != need["dilated_conv1d_bf16"] or any(
                lc[k2] for k2 in stray):
            fail(f"sts turn {i}: launches {({k2: v for k2, v in lc.items() if v})}; a "
                 f"direct synthesis launches {per_synthesis}, {turns_wall[i]['stt_calls']} "
                 "STT encodes launch dilated_conv1d_bf16 once each")
    conv_err = check_conv_path(conv_calls, convs, "STS session")
    lstm_err = check_lstm_path(lstm_calls, lstm, "STS session")
    path_shapes = {**_per_kernel(conv_calls), "lstm": len(lstm_calls)}
    del conv_calls, lstm_calls
    torch.cuda.empty_cache()

    tf = sts_chat_against_float32(chat, chat._build_prompt_ids(turns[0]["messages"][0][1][
        "user_transcript"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_turn = [{"launches": {k2: v for k2, v in launches[f"sts_turn_{i}"].items() if v},
                 **{k2: round(v, 4) if isinstance(v, float) else v
                    for k2, v in turns_wall[i].items()}}
                for i in range(STS_TURNS + 1)]
    for i, turn in enumerate(turns):
        per_turn[i].update(speech_end_to_audio_ms=turn["speech_end_to_audio_ms"],
                           flush_to_audio_ms=turn["flush_to_audio_ms"],
                           chunks=sum(m[0] == "bytes" for m in turn["messages"]))
    per_turn[-1].update(bridge_speech_end_to_reply_s=bridge["speech_end_to_reply_s"],
                        bridge_silence_frames=bridge["silence_frames"])
    card = gpu_line()
    for i, row in enumerate(per_turn):
        label = "WebRTC bridge turn" if i == STS_TURNS else f"/ws/sts turn {i}"
        print(f"sts {label}: {json.dumps(row)}; on {card}", flush=True)
    print(f"sts session: prewarm ({issued} calls) {prewarm_s:.3f} s; built in {build_s:.1f} s; "
          f"chunks {'bit for bit' if exact else f'within {err:.3e}'} a direct generate's; "
          f"replies equal a direct respond_stream's; bridge audio {bridge_err:.3e} from a "
          f"direct generate resampled; peak memory {peak:.2f} GB; a direct synthesis "
          f"launches {json.dumps(per_synthesis)}; on {card}", flush=True)
    return {"prewarm_s": prewarm_s, "prewarm_calls": issued, "build_s": build_s,
            "turns": per_turn,
            "chunks_exact": exact, "chunk_max_abs": err, "bridge_max_abs": bridge_err,
            "chat_against_float32": tf, "conv_path_err": conv_err, "lstm_path_err": lstm_err,
            "path_shapes": path_shapes, "per_synthesis": per_synthesis,
            "peak_memory_gb": peak}


# ---------------------------------------------------------------------------
# Phase 16: the CSM remainder (an HF-transformers CSM-1B directory through
# load_model, Mimi's own loaders, SilentCipher) and the S3 speech tokenizers
# ---------------------------------------------------------------------------

LLAMA3_ROPE = {"factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
               "original_max_position_embeddings": 8192, "rope_type": "llama3"}
# sesame/csm-1b's config.json in HF-transformers' CsmConfig field names: the
# published values, whose widths are CSM_CONFIG's llama-1B and llama-100M
# flavors and mimi_202407(32)
CSM_HF_CONFIG = {
    "architectures": ["CsmForConditionalGeneration"], "model_type": "csm",
    "num_codebooks": 32, "vocab_size": 2051, "text_vocab_size": 128_256,
    "hidden_size": 2048, "intermediate_size": 8192, "num_hidden_layers": 16,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64,
    "rms_norm_eps": 1e-5, "max_position_embeddings": 2048, "rope_theta": 500_000,
    "rope_scaling": LLAMA3_ROPE, "attention_bias": False, "mlp_bias": False,
    "hidden_act": "silu", "bos_token_id": 128_000, "pad_token_id": 128_002,
    "audio_token_id": 128_002, "audio_eos_token_id": 128_003,
    "codebook_pad_token_id": 2050, "codebook_eos_token_id": 0,
    "tie_codebooks_embeddings": True,
    "depth_decoder_config": {
        "model_type": "csm_depth_decoder_model", "num_codebooks": 32,
        "vocab_size": 2051, "backbone_hidden_size": 2048, "hidden_size": 1024,
        "intermediate_size": 8192, "num_hidden_layers": 4, "num_attention_heads": 8,
        "num_key_value_heads": 2, "head_dim": 128, "rms_norm_eps": 1e-5,
        "max_position_embeddings": 33, "rope_theta": 500_000,
        "rope_scaling": LLAMA3_ROPE, "attention_bias": False, "mlp_bias": False,
        "hidden_act": "silu"},
    "codec_config": {
        "model_type": "mimi", "sampling_rate": 24_000, "audio_channels": 1,
        "hidden_size": 512, "num_filters": 64, "num_residual_layers": 1,
        "upsampling_ratios": [8, 6, 5, 4], "kernel_size": 7, "last_kernel_size": 3,
        "residual_kernel_size": 3, "dilation_growth_rate": 2, "use_causal_conv": True,
        "pad_mode": "constant", "compress": 2, "trim_right_ratio": 1.0,
        "codebook_size": 2048, "codebook_dim": 256, "num_quantizers": 32,
        "use_conv_shortcut": False, "vector_quantization_hidden_dimension": 256,
        "upsample_groups": 512, "num_hidden_layers": 8, "intermediate_size": 2048,
        "num_attention_heads": 8, "num_key_value_heads": 8, "head_dim": 64,
        "hidden_act": "gelu", "max_position_embeddings": 8000, "norm_eps": 1e-5,
        "rope_theta": 10000.0, "sliding_window": 250,
        "layer_scale_initial_scale": 0.01, "attention_bias": False,
        "num_semantic_quantizers": 1},
}
PHASE16_RUNS = ("csm_hf_generate_spec", "s3_v1_encode", "s3_v2_encode")
# phase 17's runs
MESH_RUNS = ("mesh_csm_none", "mesh_csm_dp2_tp2", "mesh_csm_tp2", "mesh_kokoro_none",
             "mesh_kokoro_dp4", "mesh_serve_tts")
MIMI_SECONDS = 2.0  # the clip Mimi's loaders encode
S3_SECONDS = (30.0, 21.3)  # the batch of 2 the S3 tokenizers encode
S3_TIE = 1e-4  # a code may differ from the CPU's where its margin is below this
S3_TIE_SHARE = 0.01  # at most this share of the codes may so differ
SC_REL_RMS = 1e-4  # SilentCipher's perturbation against the CPU's
SC_MIN_SDR = 30.0


def _mimi_conv_out(w: np.ndarray, transposed: bool) -> np.ndarray:
    """The JAX package's conv layout [K, I, O] -> torch's: a conv [O, I, K],
    a transposed conv [I, O/g, K]."""
    return np.ascontiguousarray(w.transpose(1, 2, 0) if transposed else w.transpose(2, 1, 0))


def _seanet_index(side: str, rest: list, n_ratios: int):
    """(HF / Kyutai SEANet index, block tap, remaining path) of a JAX SEANet
    path's components after ``side``."""
    if rest[0] == "init_conv1d":
        return 0, None, rest[1:]
    if rest[0] == "final_conv1d":
        return 3 * n_ratios + 2, None, rest[1:]
    i = int(rest[1])
    if rest[2] == "residuals":  # layers.i.residuals.0.block.j.<param>
        base = 3 * i + 1 if side == "encoder" else 3 * i + 3
        return base, int(rest[5]), rest[6:]
    # layers.i.downsample / layers.i.upsample
    return (3 * i + 3 if side == "encoder" else 3 * i + 2), None, rest[3:]


def _rope_permute(w: np.ndarray, n_heads: int) -> np.ndarray:
    """Interleaved-pair q/k rows -> HF's rotate-half order (the inverse of
    ``codec.mimi.mimi._unpermute_rope``)."""
    o, i = w.shape
    return w.reshape(n_heads, o // n_heads // 2, 2, i).swapaxes(1, 2).reshape(o, i)


def hf_mimi_weights(named: dict, n_heads: int = 8, n_ratios: int = 4) -> dict:
    """A Mimi in the JAX package's paths and layouts -> an HF-transformers
    ``MimiModel`` state (``kyutai/mimi``'s layout): the inverse of
    ``sanitize_hf_mimi``."""
    out = {}
    for k, v in named.items():
        v = np.asarray(v)
        parts = k.split(".")
        if parts[0] in ("encoder", "decoder"):
            idx, tap, rest = _seanet_index(parts[0], parts[1:], n_ratios)
            mid = f"block.{2 * tap + 1}.conv" if tap is not None else "conv"
            if v.ndim == 3:
                v = _mimi_conv_out(v, ".upsample." in k)
            out[f"{parts[0]}.layers.{idx}.{mid}.{'.'.join(rest)}"] = v
            continue
        if k.endswith(".self_attn.in_proj.weight"):
            pre = k[: -len("in_proj.weight")]
            q, kk, vv = np.split(v, 3, axis=0)
            out[pre + "q_proj.weight"] = np.ascontiguousarray(_rope_permute(q, n_heads))
            out[pre + "k_proj.weight"] = np.ascontiguousarray(_rope_permute(kk, n_heads))
            out[pre + "v_proj.weight"] = np.ascontiguousarray(vv)
            continue
        for ours, theirs in ((".self_attn.out_proj.", ".self_attn.o_proj."),
                             (".gating.linear1.", ".mlp.fc1."), (".gating.linear2.", ".mlp.fc2."),
                             (".norm1.", ".input_layernorm."),
                             (".norm2.", ".post_attention_layernorm."),
                             (".layer_scale_1.scale", ".self_attn_layer_scale.scale"),
                             (".layer_scale_2.scale", ".mlp_layer_scale.scale"),
                             (".rvq_first.vq.layers.", ".semantic_residual_vector_quantizer.layers."),
                             (".rvq_rest.vq.layers.", ".acoustic_residual_vector_quantizer.layers."),
                             (".rvq_first.", ".semantic_residual_vector_quantizer."),
                             (".rvq_rest.", ".acoustic_residual_vector_quantizer."),
                             (".codebook.embedding_sum", ".codebook.embed_sum")):
            k = k.replace(ours, theirs)
        if k in ("downsample.weight", "upsample.weight"):
            v = _mimi_conv_out(v, k == "upsample.weight")
            k = k.replace(".weight", ".conv.weight")
        elif k.endswith(("input_proj.weight", "output_proj.weight")):
            v = v[..., None]  # Linear [O, I] -> 1x1 conv [O, I, 1]
        out[k] = v
    return out


def kyutai_mimi_weights(named: dict) -> dict:
    """A Mimi in the JAX package's paths and layouts -> the Kyutai torch
    checkpoint's keys and layouts (one ``.safetensors`` file): the inverse of
    ``sanitize_mimi``, whose SEANet indices are those of 4 ratios."""
    out = {}
    for k, v in named.items():
        v = np.asarray(v)
        parts = k.split(".")
        if parts[0] in ("encoder", "decoder"):
            idx, tap, rest = _seanet_index(parts[0], parts[1:], 4)
            up = ".upsample." in k
            mid = (f"block.{2 * tap + 1}.conv.conv" if tap is not None
                   else "convtr.convtr" if up else "conv.conv")
            if v.ndim == 3:
                v = _mimi_conv_out(v, up)
            out[f"{parts[0]}.model.{idx}.{mid}.{'.'.join(rest)}"] = v
            continue
        k = (k.replace(".self_attn.in_proj.weight", ".self_attn.in_proj_weight")
             .replace(".gating.linear", ".linear").replace(".codebook.", "._codebook."))
        if k in ("downsample.weight", "upsample.weight"):
            v = _mimi_conv_out(v, k == "upsample.weight")
            k = ("downsample.conv.conv.weight" if k == "downsample.weight"
                 else "upsample.convtr.convtr.weight")
        elif k.endswith(("input_proj.weight", "output_proj.weight")):
            v = v[..., None]
        out[k] = v
    return out


def hf_csm_weights(named: dict, n_mimi_heads: int = 8, n_ratios: int = 4) -> dict:
    """A CSM (the JAX package's ``model.*`` and ``_mimi.*`` paths) -> an
    HF-transformers ``CsmForConditionalGeneration`` state, as
    ``save_pretrained`` writes it: the tied audio-embedding table only as the
    depth decoder's copy, no RoPE tables; the inverse of ``sanitize_hf_csm``."""
    fixed = {"model.text_embeddings.weight": "embed_text_tokens.weight",
             "model.audio_embeddings.weight": "depth_decoder.model.embed_tokens.weight",
             "model.codebook0_head.weight": "lm_head.weight",
             "model.audio_head": "depth_decoder.codebooks_head.weight",
             "model.projection.weight": "depth_decoder.model.inputs_embeds_projector.weight"}
    out = {f"codec_model.{k}": v for k, v in hf_mimi_weights(
        {k[len("_mimi."):]: v for k, v in named.items() if k.startswith("_mimi.")},
        n_mimi_heads, n_ratios).items()}
    for k, v in named.items():
        if k.startswith("_mimi.") or k.endswith(("rope_cos", "rope_sin")):
            continue
        if k in fixed:
            k = fixed[k]
        elif k.startswith("model.decoder."):
            k = "depth_decoder.model." + k[len("model.decoder."):]
        elif k.startswith("model.backbone."):
            k = "backbone_model." + k[len("model.backbone."):]
        out[k] = np.ascontiguousarray(v)
    return out


def s3_mlx_weights(named: dict) -> dict:
    """An S3 tokenizer in the JAX package's layouts -> the MLX community
    safetensors' (conv weights [O, K, I])."""
    return {k: np.ascontiguousarray(v.transpose(2, 0, 1) if k.endswith(".weight")
                                    and v.ndim == 3 else v) for k, v in named.items()}


def silentcipher_torch_weights(state: dict, seed: int = 0) -> dict:
    """A SilentCipher state in torch's layouts -> a torch checkpoint as a
    DataParallel run saves it (``module.`` prefixes), with one array of the
    ``dec_c`` carrier-SDR estimator that loading drops."""
    out = {f"module.{k}": np.ascontiguousarray(v) for k, v in state.items()}
    rng = np.random.default_rng(seed)
    out["module.dec_c.conv_in.weight"] = rng.standard_normal((8, 1, 3, 3)).astype(np.float32)
    return out


def weights_digest(model) -> list:
    """Per tensor (RoPE tables aside) its float64 sum and sum of squares:
    two models built from one seed agree on it to the bit."""
    return [(k, float(t.double().sum()), float(t.double().pow(2).sum()))
            for k, t in model.state_dict().items()
            if t.is_floating_point() and "rope_" not in k]


def hold_extra_codes(model) -> None:
    """Codes past Mimi's 2048 bins (the audio vocabulary has 2051) decode to
    NaN; a trained CSM does not emit them, so neither do these random
    weights: their logits are held at 0, below the top of 2048 random ones."""
    bins = model.mimi.cfg.quantizer_bins
    with torch.no_grad():
        model.model.codebook0_head.weight[bins:] = 0
        model.model.audio_head[..., bins:] = 0


def _save(weights: dict, path: Path) -> None:
    from safetensors.numpy import save_file

    save_file(weights, str(path))


def csm_hf_runs(launches: dict, tmp: Path, phase5: dict) -> dict:
    """Step 1: a CSM-1B HF-transformers directory from the seeded source
    (phase 5's weights, checked by digest), read by ``load_model``: every
    tensor bit for bit; then int8 and spec decode, whose greedy frames must
    be phase 5's.  Step 2: Mimi's loaders on the same Mimi."""
    from mlx_audio_tpu_torch.convert import params_to_jax
    from mlx_audio_tpu_torch.models.tts.sesame import Model
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.nn.quantize import quantize_model
    from mlx_audio_tpu_torch.utils.loader import load_model

    src = Model(CSM_HF_CONFIG, text_tokenizer=StubTokenizer(), device="cuda")
    hold_extra_codes(src)
    if weights_digest(src) != phase5["digest"]:
        fail("csm hf: the source's weights are not phase 5's")
    d = tmp / "csm-1b-hf"
    d.mkdir()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    named = params_to_jax(src.state_dict(), src)
    _save(hf_csm_weights(named), d / "model.safetensors")
    with open(d / "config.json", "w") as f:
        json.dump(CSM_HF_CONFIG, f)
    write_s = time.perf_counter() - t0
    size_gb = sum(p.stat().st_size for p in d.iterdir()) / 1e9
    t0 = time.perf_counter()
    model = load_model(str(d), domain="tts", device="cuda", strict=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    _check_same_state("csm hf load_model", model, src)
    del src
    torch.cuda.empty_cache()
    print(f"csm hf: {d.name} ({size_gb:.3f} GB, the tied audio table as the depth "
          f"decoder's copy only) written in {write_s:.2f} s, read by load_model in "
          f"{load_s:.2f} s; every tensor equal to the source's bit for bit", flush=True)

    mimi_out = mimi_loader_runs(model, named, tmp)
    del named

    model._text_tokenizer = StubTokenizer()
    quantize_model(model.model, group_size=128, bits=8)
    model.model.enable_spec_decode()
    ref = (np.random.default_rng(0).standard_normal(48_000) * 0.1).astype(np.float32)
    decoded = []
    decode = model.mimi.decode

    def recording_decode(codes):
        audio = decode(codes)
        decoded.append((codes.clone(), audio[0, 0].cpu().numpy()))
        return audio

    path_calls, wall = {}, {}
    qmm = record_qmm_calls(path_calls)
    model.mimi.decode = recording_decode
    run = path_runner(launches, wall)
    try:
        out = run("csm_hf_generate_spec", lambda: list(model.generate(
            CSM_TEXT, temperature=0.0, ref_audio=ref, ref_text=CSM_REF_TEXT,
            max_audio_length_ms=CSM_FRAMES * 80)))
    finally:
        model.mimi.decode = decode
        kernels.quantized_matmul = qmm
    _check_results("csm hf generate (spec)", out, CSM_FRAMES)
    if not torch.equal(decoded[0][0].cpu(), phase5["spec_codes"]):
        n = int((decoded[0][0].cpu() != phase5["spec_codes"]).sum())
        fail(f"csm hf: greedy spec frames differ from phase 5's source ({n} codes)")
    lc = launches["csm_hf_generate_spec"]
    missing = [k for k in ("quantized_matmul", "depth_draft") if not lc[k]]
    if missing:
        fail(f"csm_hf_generate_spec: kernels never launched: {missing}")
    qmm_err = check_qmm_path(path_calls, qmm, "HF-loaded CSM")
    per_frame = {k: lc[k] / CSM_FRAMES for k in ("quantized_matmul", "depth_draft")}
    print(f"csm hf: int8 spec greedy generate of {CSM_FRAMES} frames equal to phase 5's "
          f"source; {CSM_FRAMES / wall['csm_hf_generate_spec']:.2f} frames a wall second "
          f"({wall['csm_hf_generate_spec']:.3f} s); per frame {json.dumps(per_frame)}",
          flush=True)
    return {"model": model, "audio": decoded[0][1], "write_s": write_s, "load_s": load_s,
            "size_gb": size_gb, "frames_per_s": CSM_FRAMES / wall["csm_hf_generate_spec"],
            "per_frame": per_frame, "qmm_path_err": qmm_err,
            "qmm_path_shapes": len(path_calls), "mimi": mimi_out}


def mimi_loader_runs(model, named: dict, tmp: Path) -> dict:
    """``Mimi.from_pretrained`` on a kyutai/mimi-layout HF directory and on a
    Kyutai-layout file, both written from ``model``'s Mimi: each loaded
    state equal bit for bit, and on a seeded clip codes equal to the
    source's and audio within 1e-5."""
    from mlx_audio_tpu_torch.codec.mimi import Mimi

    mimi_named = {k[len("_mimi."):]: v for k, v in named.items() if k.startswith("_mimi.")}
    hf_dir = tmp / "mimi-hf"
    hf_dir.mkdir()
    _save(hf_mimi_weights(mimi_named), hf_dir / "model.safetensors")
    with open(hf_dir / "config.json", "w") as f:
        json.dump(CSM_HF_CONFIG["codec_config"], f)
    kyutai = tmp / "mimi-kyutai.safetensors"
    _save(kyutai_mimi_weights(mimi_named), kyutai)
    src = model.mimi
    pcm = (np.random.default_rng(16).standard_normal(int(MIMI_SECONDS * 24_000)) * 0.1
           ).astype(np.float32)
    x = torch.as_tensor(pcm, device="cuda")[None, None]
    want_codes = src.encode(x)
    want_audio = src.decode(want_codes)
    out = {}
    for name, path in (("hf_directory", hf_dir), ("kyutai_file", kyutai)):
        t0 = time.perf_counter()
        m = Mimi.from_pretrained(str(path), device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        _check_same_state(f"mimi from_pretrained ({name})", m, src)
        codes = m.encode(x)
        if not torch.equal(codes, want_codes):
            fail(f"mimi from_pretrained ({name}): {int((codes != want_codes).sum())} "
                 "codes differ from the source's")
        err = float((m.decode(codes) - want_audio).abs().max())
        if err > 1e-5:
            fail(f"mimi from_pretrained ({name}): audio {err:.3e} from the source's")
        out[name] = {"load_s": load_s, "audio_err": err}
        del m
    print(f"mimi: from_pretrained of an HF directory and of a Kyutai file: state bit for "
          f"bit, {want_codes.shape[-1]} frames x {want_codes.shape[1]} codes equal, audio "
          f"within 1e-5 ({json.dumps(out)})", flush=True)
    return out


def silentcipher_runs(csm: dict, tmp: Path) -> dict:
    """Step 3: SilentCipher at ``SilentCipherConfig()``, seeded weights written
    as a torch checkpoint and read by ``load_watermarker``; the CSM output of
    step 1 watermarked by the model's own ``_watermark`` through
    ``$MLX_AUDIO_TPU_SILENTCIPHER`` and verified; ``encode_wav`` and
    ``decode_wav`` against the same weights on the CPU."""
    import os

    from mlx_audio_tpu_torch.models.tts.sesame.silentcipher import SilentCipherModel
    from mlx_audio_tpu_torch.models.tts.sesame.watermarking import (
        CSM_1B_GH_WATERMARK,
        load_watermarker,
        verify,
    )
    from mlx_audio_tpu_torch.utils.audio_io import resample_audio

    src = SilentCipherModel(device="cuda", seed=0)
    d = tmp / "silentcipher"
    d.mkdir()
    _save(silentcipher_torch_weights({k: t.cpu().numpy() for k, t in
                                      src.state_dict().items()}), d / "model.safetensors")
    wm = load_watermarker(str(d))
    if not isinstance(wm, SilentCipherModel):
        fail(f"load_watermarker({d.name}): {type(wm).__name__}, not SilentCipherModel")
    _check_same_state("load_watermarker", wm, src)
    old = os.environ.get("MLX_AUDIO_TPU_SILENTCIPHER")
    os.environ["MLX_AUDIO_TPU_SILENTCIPHER"] = str(d)
    try:
        t0 = time.perf_counter()
        marked = csm["model"]._watermark(csm["audio"])
        mark_s = time.perf_counter() - t0
        verified = verify(load_watermarker(), marked, 24_000, CSM_1B_GH_WATERMARK)
    finally:
        if old is None:
            del os.environ["MLX_AUDIO_TPU_SILENTCIPHER"]
        else:
            os.environ["MLX_AUDIO_TPU_SILENTCIPHER"] = old
    if not (marked.shape == csm["audio"].shape and np.isfinite(marked).all()):
        fail("silentcipher: the watermarked CSM output is not finite or changed length")

    cfg = wm.cfg
    cpu = cpu_twin(lambda: SilentCipherModel(cfg, device="cpu"), wm)
    clip = (np.random.default_rng(17).standard_normal(int(MIMI_SECONDS * 44_100)) * 0.1
            ).astype(np.float32)
    out = {"verify": bool(verified), "csm_watermark_s": mark_s,
           "csm_audio_rms": float(np.sqrt(np.mean(csm["audio"] ** 2)))}
    # the CSM output, and a seeded clip at speech level: the SDR bound holds
    # where the carrier is above the perturbation's 1e-9 power floor
    for name, audio in (("csm_output", resample_audio(csm["audio"], 24_000, 44_100)),
                        ("clip", clip)):
        out_card = wm.encode_wav(audio, 44_100, CSM_1B_GH_WATERMARK)[0]
        encode_ms = _wall(lambda: wm.encode_wav(audio, 44_100, CSM_1B_GH_WATERMARK)) * 1e3
        dec_card = wm.decode_wav(out_card, 44_100)
        decode_ms = _wall(lambda: wm.decode_wav(out_card, 44_100)) * 1e3
        out_cpu = cpu.encode_wav(audio, 44_100, CSM_1B_GH_WATERMARK)[0]
        dec_cpu = cpu.decode_wav(out_card, 44_100)
        pert = rel_rms(torch.as_tensor(out_card - audio), torch.as_tensor(out_cpu - audio))
        delta = out_card - audio
        sdr = float(10 * np.log10(np.mean(audio ** 2) / (np.mean(delta ** 2) + 1e-30)))
        if pert > SC_REL_RMS:
            fail(f"silentcipher ({name}): the card's perturbation {pert:.3e} (relative "
                 "RMS) from the CPU's")
        if dec_card["messages"] != dec_cpu["messages"]:
            fail(f"silentcipher ({name}): decode_wav messages {dec_card['messages']} on "
                 f"the card, {dec_cpu['messages']} on the CPU")
        if name == "clip" and sdr < SC_MIN_SDR:
            fail(f"silentcipher ({name}): SDR {sdr:.2f} dB < {SC_MIN_SDR}")
        out[name] = {"perturbation_rel_rms": pert, "sdr_db": sdr,
                     "confidence_err": abs(dec_card["confidence"] - dec_cpu["confidence"]),
                     "messages": dec_card["messages"][0], "status": bool(dec_card["status"]),
                     "encode_ms": encode_ms, "decode_ms": decode_ms,
                     "seconds": len(audio) / 44_100}
    print(f"silentcipher: {json.dumps(out)} (verify: whether random weights decode "
          "the key)", flush=True)
    return out


def _s3_batch(device: str):
    """A seeded 30 s clip and a shorter one as a padded mel batch [2, 128, T]
    and its lengths.  30 s make 3001 frames: the last, past the encoder's
    1500 positions, is dropped, as Whisper's log-mel drops it."""
    from mlx_audio_tpu_torch.codec.s3 import S3Config, log_mel_spectrogram

    frames = 2 * S3Config().n_audio_ctx
    mels = [log_mel_spectrogram(torch.as_tensor(_clip(20 + i, s), device=device))[:, :frames]
            for i, s in enumerate(S3_SECONDS)]
    t = max(m.shape[1] for m in mels)
    mel = torch.stack([torch.nn.functional.pad(m, (0, t - m.shape[1])) for m in mels])
    return mel, torch.as_tensor([m.shape[1] for m in mels], device=device)


def _s3_margins(tok, hidden: torch.Tensor) -> torch.Tensor:
    """Each code's margin on the CPU: v1, the VQ distance from the runner-up
    to the winner; v2, the least distance of the 8 FSQ digits' pre-rounding
    values from a rounding boundary (+-0.5)."""
    from mlx_audio_tpu_torch.codec.s3.s3 import FSQCodebook

    q = tok.quantizer
    if isinstance(q, FSQCodebook):
        h = torch.tanh(q.project_down(hidden).float()) * 0.9990000128746033
        return (h.abs() - 0.5).abs().min(-1).values
    x = hidden / torch.sqrt((hidden ** 2).sum(-1, keepdim=True) + 1e-8)
    e = q.embed.float()
    dist = (x ** 2).sum(-1, keepdim=True) - 2 * x @ e.t() + (e ** 2).sum(1)
    two = dist.topk(2, dim=-1, largest=False).values
    return two[..., 1] - two[..., 0]


def s3_runs(launches: dict, tmp: Path) -> dict:
    """Step 4: S3 v1 (50 Hz) and v2 (25 Hz) at ``S3Config()``'s widths,
    written as MLX-layout directories and read by ``from_pretrained``; a
    batch of 2 clips on the card against the same weights on the CPU."""
    from mlx_audio_tpu_torch.codec.s3 import S3Tokenizer, S3TokenizerV2
    from mlx_audio_tpu_torch.convert import params_to_jax
    from mlx_audio_tpu_torch.nn import kernels

    mel, mel_len = _s3_batch("cuda")
    mel_cpu, len_cpu = mel.cpu(), mel_len.cpu()
    out, wall = {}, {}
    run = path_runner(launches, wall)
    conv_calls = {}
    for cls, name, run_name in ((S3Tokenizer, "speech_tokenizer_v1", "s3_v1_encode"),
                                (S3TokenizerV2, "speech_tokenizer_v2_25hz", "s3_v2_encode")):
        src = cls(name, device="cuda", seed=0)
        d = tmp / "s3" / name
        d.mkdir(parents=True)
        _save(s3_mlx_weights(params_to_jax(src.state_dict(), src)), d / f"{name}.safetensors")
        tok = cls.from_pretrained(name, repo_id=str(d), device="cuda")
        _check_same_state(f"{name} from_pretrained", tok, src)
        del src
        wrappers = record_conv_calls(conv_calls)
        try:
            codes, lens = run(run_name, lambda: tok.quantize(mel, mel_len))
        finally:
            kernels.banded_conv1d, kernels.dilated_conv1d = wrappers
        want = {"dilated_conv1d": 1} if run_name == "s3_v1_encode" else {}
        _check_only(run_name, launches[run_name], want)
        encode_ms = _timed(lambda: tok.quantize(mel, mel_len)) * 1e3
        cpu = cpu_twin(lambda: cls(name, device="cpu"), tok)
        with torch.no_grad():
            hidden, lens_cpu = cpu.encoder(mel_cpu, len_cpu)
            codes_cpu = cpu.quantizer.encode(hidden)
            margin = _s3_margins(cpu, hidden)
        if not torch.equal(lens.cpu(), lens_cpu):
            fail(f"{name}: code lengths {lens.tolist()} on the card, {lens_cpu.tolist()} "
                 "on the CPU")
        valid = torch.arange(codes_cpu.shape[1])[None, :] < lens_cpu[:, None]
        differ = (codes.cpu() != codes_cpu) & valid
        ties = (margin < S3_TIE) & valid
        n_codes = int(valid.sum())
        if bool((differ & ~ties).any()):
            fail(f"{name}: {int((differ & ~ties).sum())} codes differ from the CPU's "
                 f"where its margin is {S3_TIE} or more")
        if int(differ.sum()) > S3_TIE_SHARE * n_codes:
            fail(f"{name}: {int(differ.sum())} of {n_codes} codes differ at near-ties")
        out[name] = {"codes": n_codes, "distinct": int(torch.unique(codes_cpu[valid]).numel()),
                     "near_ties": int(ties.sum()), "differ": int(differ.sum()),
                     "lengths": lens_cpu.tolist(), "encode_ms": encode_ms,
                     "launches": {k: v for k, v in launches[run_name].items() if v}}
        del tok, cpu
        torch.cuda.empty_cache()
    conv_err = check_conv_path(conv_calls, wrappers, "S3 v1")
    print(f"s3: a batch of {len(S3_SECONDS)} clips ({', '.join(map(str, S3_SECONDS))} s): "
          f"{json.dumps(out)}", flush=True)
    return {"runs": out, "conv_path_err": conv_err,
            "conv_path_shapes": _per_kernel(conv_calls)}


# ---------------------------------------------------------------------------
# phase 17: the device mesh on one card
# ---------------------------------------------------------------------------

MESH_FRAMES = 12  # frames of each CSM generate_batch
MESH_KOKORO_DP = 4


def mesh_devices(n: int) -> list:
    """One card listed n times: the mesh's devices on a one-card host."""
    return [torch.device("cuda", 0)] * n


def csm_mesh_runs(model, launches: dict) -> dict:
    """CSM-1B int8 (phase 16's HF-loaded model): ``generate_batch`` of the 4
    CSM_BATCH_TEXTS, greedy, MESH_FRAMES frames, under no mesh, under
    dp=2,tp=2 over [cuda:0] * 4 and under tp=2 alone (dp=1): the frames of
    each sharded run equal the unsharded run's; every ``quantized_matmul``
    shape each run gave it held to the plain version on the run's operands.
    Prints the kernel's launches a frame and the shard shapes."""
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.parallel.context import activate_mesh, deactivate_mesh

    ref = (np.random.default_rng(0).standard_normal(48_000) * 0.1).astype(np.float32)
    kw = dict(temperature=0.0, ref_audio=ref, ref_text=CSM_REF_TEXT,
              max_audio_length_ms=MESH_FRAMES * 80)
    decode = model.mimi.decode
    wall, out = {}, {}
    run = path_runner(launches, wall)
    for name, spec in (("mesh_csm_none", None), ("mesh_csm_dp2_tp2", dict(dp=2, tp=2)),
                       ("mesh_csm_tp2", dict(dp=1, tp=2))):
        codes, path_calls = [], {}
        model.mimi.decode = lambda c: (codes.append(c.clone()), decode(c))[1]
        qmm = record_qmm_calls(path_calls)
        try:
            if spec:
                activate_mesh(devices=mesh_devices(4), **spec)
            results = run(name, lambda: model.generate_batch(CSM_BATCH_TEXTS, **kw))
        finally:
            deactivate_mesh()
            kernels.quantized_matmul = qmm
            model.mimi.decode = decode
        _check_results(f"csm {name}", results)
        frames = torch.cat(codes)                  # [rows, 32, frames]
        n_frames = frames.shape[-1]
        lc = launches[name]
        if not lc["quantized_matmul"]:
            fail(f"{name}: quantized_matmul never launched")
        err = check_qmm_path(path_calls, qmm, name)
        out[name] = {"wall_s": wall[name], "frames": n_frames,
                     "qmm_per_frame": lc["quantized_matmul"] / n_frames,
                     "qmm_shapes": sorted({k[:3] for k in path_calls}),
                     "qmm_path_err": err, "codes": frames.cpu()}
    base = out["mesh_csm_none"]["codes"]
    for name in ("mesh_csm_dp2_tp2", "mesh_csm_tp2"):
        got = out[name].pop("codes")
        if got.shape != base.shape or not torch.equal(got, base):
            n = int((got != base).sum()) if got.shape == base.shape else -1
            fail(f"csm {name}: greedy frames differ from the unsharded run's "
                 f"({n} codes of {base.numel()}; shapes {list(got.shape)}, {list(base.shape)})")
    out["mesh_csm_none"].pop("codes")
    # the shards' shapes, and the replicas' row counts: (rows, I, O) the
    # sharded runs gave the kernel that the unsharded run did not
    plain_shapes = set(map(tuple, out["mesh_csm_none"]["qmm_shapes"]))
    for name in ("mesh_csm_dp2_tp2", "mesh_csm_tp2"):
        out[name]["new_shapes"] = sorted(set(map(tuple, out[name]["qmm_shapes"])) - plain_shapes)
    print("phase 17 csm: frames under dp=2,tp=2 and tp=2 over [cuda:0] x 4 equal the "
          f"unsharded run's ({len(CSM_BATCH_TEXTS)} rows x 32 codebooks x "
          f"{out['mesh_csm_none']['frames']} frames); " + "; ".join(
              f"{k}: {v['wall_s']:.3f} s, quantized_matmul {v['qmm_per_frame']:.2f} a frame"
              f", (rows, I, O) the unsharded run did not give it {v.get('new_shapes', [])}"
              for k, v in out.items()),
          flush=True)
    return out


def kokoro_mesh_runs(launches: dict, kdir: str, voice: str, workers: tuple) -> dict:
    """Kokoro-82M from phase 14's native checkpoint: ``synthesize_batch`` of
    the 8 SERVE_TEXTS under no mesh and under dp=MESH_KOKORO_DP over
    [cuda:0] * 4: durations equal, each row held to the unsharded run's
    past SERVE_HEAD by phase 14's row bounds; every conv and lstm launch of
    the dp run held to its plain version on its operands; the dp run
    launches each kernel MESH_KOKORO_DP times as often as the unsharded run
    (each replica runs a whole synthesis of its rows).  Then the same
    batch over MESH_PROCESSES processes (``kokoro_process_runs``, the
    ``workers`` that ``start_process_workers`` started)."""
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.parallel.context import activate_mesh, deactivate_mesh
    from mlx_audio_tpu_torch.utils.loader import load_model

    model = load_model(kdir, device="cuda")
    refs = _serve_refs(voice)
    wall, outs = {}, {}
    run = path_runner(launches, wall)
    for name, spec in (("mesh_kokoro_none", None), ("mesh_kokoro_dp4", f"dp={MESH_KOKORO_DP}")):
        # both runs record their operands (the same overhead); the dp run's
        # are held to the plain versions below
        conv_calls, lstm_calls = {}, {}
        convs, lstm = record_conv_calls(conv_calls), record_lstm_calls(lstm_calls)
        try:
            if spec:
                activate_mesh(spec, devices=mesh_devices(4))
            with torch.no_grad():
                outs[name] = run(name, lambda: model.synthesize_batch(
                    SERVE_TEXTS, refs, speeds=float(SERVE_SPEED)))
        finally:
            deactivate_mesh()
            kernels.banded_conv1d, kernels.dilated_conv1d = convs
            kernels.lstm = lstm
    base, dp = outs["mesh_kokoro_none"], outs["mesh_kokoro_dp4"]
    conv_err = check_conv_path(conv_calls, convs, "Kokoro dp=4")
    lstm_err = check_lstm_path(lstm_calls, lstm, "Kokoro dp=4")
    row_err = []
    for i, ((a0, d0), (a1, d1)) in enumerate(zip(base, dp)):
        if not np.array_equal(d0, d1) or a0.shape != a1.shape or not np.isfinite(a1).all():
            fail(f"kokoro dp=4 row {i}: durations or samples differ ({a1.shape}, {a0.shape})")
        diff = np.abs(a1[SERVE_HEAD:] - a0[SERVE_HEAD:])
        row_err.append({"max_abs": float(diff.max()),
                        "over_atol": int((diff > SERVE_ROW_ATOL).sum()),
                        "rel_rms": rel_rms(torch.from_numpy(a1[SERVE_HEAD:]),
                                           torch.from_numpy(a0[SERVE_HEAD:]))})
    if any(e["over_atol"] > SERVE_FLIP_SAMPLES or e["max_abs"] > SERVE_FLIP_MAX_ABS
           or e["rel_rms"] > SERVE_ROW_REL_RMS for e in row_err):
        fail(f"kokoro dp=4 rows against the unsharded run past sample {SERVE_HEAD}: "
             f"{row_err} (atol {SERVE_ROW_ATOL} but for {SERVE_FLIP_SAMPLES} samples "
             f"within {SERVE_FLIP_MAX_ABS}, relative RMS {SERVE_ROW_REL_RMS})")
    got = {k: launches["mesh_kokoro_dp4"][k] for k in KOKORO_KERNELS}
    want = {k: MESH_KOKORO_DP * launches["mesh_kokoro_none"][k] for k in KOKORO_KERNELS}
    if got != want or not all(want.values()):
        fail(f"kokoro dp=4 launches {got}, expected {MESH_KOKORO_DP} x the unsharded "
             f"run's {want}")
    audio_s = sum(a.shape[0] for a, _ in base) / model.sample_rate
    del model
    torch.cuda.empty_cache()
    processes = kokoro_process_runs(launches, workers, base, wall["mesh_kokoro_none"])
    out = {"wall_s": dict(wall), "audio_s": audio_s, "rows_past_head": row_err,
           "processes": processes,
           "conv_path_err": conv_err, "lstm_path_err": lstm_err,
           "path_shapes": {**_per_kernel(conv_calls), "lstm": len(lstm_calls)},
           "launches": {k: launches[k] for k in ("mesh_kokoro_none", "mesh_kokoro_dp4")}}
    print(f"phase 17 kokoro: dp={MESH_KOKORO_DP} rows within phase 14's row bounds past "
          f"sample {SERVE_HEAD}: relative RMS {max(e['rel_rms'] for e in row_err):.3e}, "
          f"max_abs {max(e['max_abs'] for e in row_err):.3e}, samples over "
          f"{SERVE_ROW_ATOL} {max(e['over_atol'] for e in row_err)}; launches "
          f"{json.dumps({k: {n: launches[k][n] for n in KOKORO_KERNELS} for k in out['launches']})}"
          f"; wall s {json.dumps(wall)} for {audio_s:.1f} audio-s", flush=True)
    return out


MESH_PROCESSES = 2
MESH_PROCESS_TIMEOUT_S = 300


def _serve_refs(voice: str) -> np.ndarray:
    """The voice-pack references of the 8 SERVE_TEXTS, as
    ``synthesize_batch`` takes them."""
    pack = np.load(voice)
    return np.stack([pack[min(len(p), pack.shape[0]) - 1].reshape(-1) for p in SERVE_TEXTS])


def kokoro_process_worker(go: str, ready: str, kdir: str, voice: str, tmp: str,
                          pid: str) -> None:
    """One of MESH_PROCESSES processes of phase 17's two-process step.
    Before its release it imports the port and joins the gloo group through
    a FileStore in ``tmp`` with [cuda:0] as its device.  Then it loads
    phase 14's checkpoint, warms up with the shortest of SERVE_TEXTS
    alone (this process's first use of the kernel libraries, cuBLAS and
    cuDNN), activates the mesh over the group (``activate_mesh()``: dp =
    MESH_PROCESSES, a data row a process) and calls ``synthesize_batch`` on
    the 8 SERVE_TEXTS once: the port runs this process's rows and gathers
    every row from the group.  Writes its wall seconds, launches, rows and
    every row's durations and audio to ``tmp``."""
    from mlx_audio_tpu_torch.nn import kernels
    from mlx_audio_tpu_torch.parallel import distributed
    from mlx_audio_tpu_torch.parallel.context import activate_mesh, deactivate_mesh
    from mlx_audio_tpu_torch.utils.loader import load_model

    pid = int(pid)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(MESH_PROCESSES, pid,
                           store=torch.distributed.FileStore(f"{tmp}/store", MESH_PROCESSES),
                           local_devices=[torch.device("cuda", 0)])
    hold(go, ready)
    t0 = time.perf_counter()
    model = load_model(kdir, device="cuda")
    refs = _serve_refs(voice)
    short = SERVE_TEXTS.index(min(SERVE_TEXTS, key=len))
    with torch.no_grad():
        model.synthesize(SERVE_TEXTS[short], refs[short], speed=float(SERVE_SPEED))
        torch.cuda.synchronize()
        set_up_s = time.perf_counter() - t0
        ctx = activate_mesh()
        try:
            torch.distributed.barrier()
            kernels.reset_launches()
            t0 = time.perf_counter()
            outs = model.synthesize_batch(SERVE_TEXTS, refs, speeds=float(SERVE_SPEED))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            deactivate_mesh()
    slices = ctx.row_slices(ctx.pad_rows(len(SERVE_TEXTS)))
    own = [slices[r] for r in ctx.own_rows()]
    np.savez(f"{tmp}/rows{pid}.npz", **{f"audio{i}": a for i, (a, _) in enumerate(outs)},
             **{f"dur{i}": d for i, (_, d) in enumerate(outs)})
    with open(f"{tmp}/proc{pid}.json", "w") as f:
        json.dump({"wall_s": wall, "load_and_warm_s": set_up_s,
                   "rows": [own[0][0], own[-1][1]], "dp": ctx.dp,
                   "processes": ctx.processes,
                   "mesh": [list(ctx.mesh.devices.shape), ctx.mesh.processes.tolist()],
                   "launches": {k: kernels.LAUNCHES[k] for k in KOKORO_KERNELS}}, f)
    distributed.shutdown()


def start_process_workers(kdir: str, voice: str, tmp: Path) -> tuple:
    """Start phase 17's MESH_PROCESSES ``kokoro_process_worker`` processes
    (at phase 13's start); they join their group, then wait for
    ``kokoro_process_runs`` to release them."""
    work = tmp / "processes"
    work.mkdir()
    started = [start_worker("kokoro_process_worker", [kdir, voice, work, pid], work / "go",
                            work / f"log{pid}") for pid in range(MESH_PROCESSES)]
    return [proc for proc, _ in started], [ready for _, ready in started], work


def kokoro_process_runs(launches: dict, workers: tuple, base: list,
                        base_wall: float) -> dict:
    """Phase 17's two-process step: release the MESH_PROCESSES processes of
    ``kokoro_process_worker`` (``start_process_workers``), both on cuda:0,
    the group over gloo (NCCL does not put two ranks on one card; its path
    waits for a host with a card a process).  Each process's
    ``synthesize_batch`` returns every row: its durations must equal the
    unsharded run's (``base``), each row its unsharded row within phase
    14's row bounds past SERVE_HEAD, and the two processes' rows each
    other's bit for bit; the processes own disjoint rows that cover the
    batch, and each launches every Kokoro kernel.  Prints each process's
    wall seconds against the unsharded run's."""
    procs, _, work = workers
    t0 = time.perf_counter()
    join_workers(f"kokoro over {MESH_PROCESSES} processes", procs, work / "go",
                 [work / f"log{pid}" for pid in range(MESH_PROCESSES)], MESH_PROCESS_TIMEOUT_S)
    recs = [json.loads((work / f"proc{pid}.json").read_text()) for pid in range(MESH_PROCESSES)]
    rows = [np.load(work / f"rows{pid}.npz") for pid in range(MESH_PROCESSES)]
    row_err = []
    for i, (a0, d0) in enumerate(base):
        for pid, got in enumerate(rows):
            a1 = got[f"audio{i}"]
            if not np.array_equal(got[f"dur{i}"], d0):
                fail(f"kokoro process {pid}: row {i}'s durations differ from the unsharded run's")
            if a1.shape != a0.shape or not np.isfinite(a1).all():
                fail(f"kokoro process {pid} row {i}: {a1.shape} samples, unsharded {a0.shape}")
            if pid and not np.array_equal(a1, rows[0][f"audio{i}"]):
                fail(f"kokoro process {pid} row {i}: differs from process 0's row")
        diff = np.abs(rows[0][f"audio{i}"][SERVE_HEAD:] - a0[SERVE_HEAD:])
        row_err.append({"max_abs": float(diff.max()),
                        "over_atol": int((diff > SERVE_ROW_ATOL).sum()),
                        "rel_rms": rel_rms(torch.from_numpy(rows[0][f"audio{i}"][SERVE_HEAD:]),
                                           torch.from_numpy(a0[SERVE_HEAD:]))})
    for pid, rec in enumerate(recs):
        if not all(rec["launches"].values()) or rec["processes"] != MESH_PROCESSES:
            fail(f"kokoro process {pid}: launches {rec['launches']}, processes "
                 f"{rec['processes']}")
        launches[f"mesh_kokoro_process{pid}"] = rec["launches"]
    if sorted(r for rec in recs for r in range(*rec["rows"])) != list(range(len(SERVE_TEXTS))):
        fail(f"kokoro over {MESH_PROCESSES} processes: rows {[r['rows'] for r in recs]}")
    if any(e["over_atol"] > SERVE_FLIP_SAMPLES or e["max_abs"] > SERVE_FLIP_MAX_ABS
           or e["rel_rms"] > SERVE_ROW_REL_RMS for e in row_err):
        fail(f"kokoro over {MESH_PROCESSES} processes: rows against the unsharded run past "
             f"sample {SERVE_HEAD}: {row_err}")
    out = {"process_wall_s": [r["wall_s"] for r in recs],
           "process_load_and_warm_s": [r["load_and_warm_s"] for r in recs],
           "unsharded_wall_s": base_wall,
           "total_s": time.perf_counter() - t0, "rows": [r["rows"] for r in recs],
           "mesh": recs[0]["mesh"],
           "launches": [r["launches"] for r in recs], "rows_past_head": row_err}
    print(f"phase 17 kokoro over {MESH_PROCESSES} processes (gloo, both on cuda:0; the NCCL "
          f"path waits for a host with a card a process): synthesize_batch under "
          f"activate_mesh() over the group, mesh {recs[0]['mesh']}, rows {out['rows']}; "
          f"every process returns every row, durations equal the unsharded run's, rows "
          f"within phase 14's row bounds past sample {SERVE_HEAD} (relative RMS "
          f"{max(e['rel_rms'] for e in row_err):.3e}, max_abs "
          f"{max(e['max_abs'] for e in row_err):.3e}); wall s "
          f"{', '.join(f'{w:.4f}' for w in out['process_wall_s'])} (after a one-row warm-up; "
          f"load and warm-up {', '.join(f'{w:.2f}' for w in out['process_load_and_warm_s'])}) "
          f"against the unsharded run's {base_wall:.4f}; launches a process "
          f"{json.dumps(out['launches'])}; the step took {out['total_s']:.1f} s", flush=True)
    return out


def server_mesh_run(launches: dict, kdir: str, voice: str, tmp: Path) -> dict:
    """The server set up as ``server.main`` does from ``--mesh dp=0``: on one
    card dp=1 (the batcher's max_batch stays 8); one /tts request, its wav
    held to the loaded model's own ``generate_batch`` within one PCM step."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from mlx_audio_tpu_torch import server
    from mlx_audio_tpu_torch.parallel.context import active_mesh, deactivate_mesh
    from mlx_audio_tpu_torch.utils.audio_io import load_audio

    args = server.parse_args(["--mesh", "dp=0", "--max-batch", str(SERVE_MAX_BATCH),
                              "--batch-window-ms", str(SERVE_WINDOW_MS)])
    state = server.build_state(args, output_folder=str(tmp / "mesh_served"))
    wall = {}
    try:
        ctx = active_mesh()
        if ctx is None or (ctx.dp, ctx.tp) != (1, 1) or state.batcher.max_batch != SERVE_MAX_BATCH:
            fail(f"server --mesh dp=0 on one card: mesh {ctx and (ctx.dp, ctx.tp)}, "
                 f"max_batch {state.batcher.max_batch}")

        async def one():
            async with TestClient(TestServer(server.create_app(state),
                                             host="127.0.0.1")) as client:
                return await _serve(client, launches, wall, "mesh_serve_tts",
                                    SERVE_TEXTS[1:2], kdir, voice)

        (name,) = asyncio.run(one())
        wav = load_audio(Path(state.output_folder) / name)
        with torch.no_grad():
            (own,) = state.tts_model.generate_batch(SERVE_TEXTS[1:2], voice=voice,
                                                    speed=float(SERVE_SPEED))
    finally:
        state.batcher.close()
        deactivate_mesh()
    err = float(np.abs(wav - _pcm(own.audio)).max()) if wav.shape == own.audio.shape else np.inf
    if not (np.isfinite(wav).all() and err <= PCM_STEP):
        fail(f"server --mesh dp=0: {wav.shape} samples, {err:.3e} from the model's own")
    missing = [k for k in KOKORO_KERNELS if not launches["mesh_serve_tts"][k]]
    if missing:
        fail(f"server --mesh dp=0: kernels never launched: {missing}")
    del state
    torch.cuda.empty_cache()
    print(f"phase 17 server --mesh dp=0: dp=1 tp=1 on one card, max_batch "
          f"{SERVE_MAX_BATCH}; one /tts in {wall['mesh_serve_tts']:.3f} s, its wav "
          f"{err:.3e} from the model's own", flush=True)
    return {"wall_s": wall["mesh_serve_tts"], "max_abs_diff": err}


def mesh_runs(launches: dict, csm, kdir: str, voice: str, tmp: Path, workers: tuple) -> dict:
    """Phase 17: the mesh on one card (CSM-1B, Kokoro-82M, the server).
    The two-process step's ``workers`` were started and set up before."""
    t0 = time.perf_counter()
    out = {"csm": csm_mesh_runs(csm, launches),
           "kokoro": kokoro_mesh_runs(launches, kdir, voice, workers),
           "server": server_mesh_run(launches, kdir, voice, tmp)}
    out["seconds"] = time.perf_counter() - t0
    return out



# ---------------------------------------------------------------------------
# Phase 18: export.py -- the port's programs through torch.export, the
# kernels custom-op nodes, loaded back and launched
# ---------------------------------------------------------------------------

# Depth cut of the exported LMs and Whisper: tracing and saving a program
# take time in proportion to its graph nodes and weight bytes (about 6 ms a
# node on the card's host, 8 GB for Orpheus-3B's two programs at full
# depth), so CSM-1B's backbone and depth decoder, Orpheus-3B and Whisper's
# encoder and decoder keep EXPORT_LAYERS layers at their published widths
EXPORT_LAYERS = 2
EXPORT_CSM_CHUNK = 4  # frames of the CSM chunk program
EXPORT_CSM_MAX = 16  # frames of the exported CSM caches past the prompt
EXPORT_MIMI_FRAMES = 5  # codes of the batch Mimi program
EXPORT_MIMI_CHUNK = 1  # frames a stateful Mimi chunk (3 chunks)
EXPORT_TOKENS_CHUNK = 8  # tokens of the Orpheus chunk program (2 chunks)
EXPORT_SNAC_FRAMES = 8  # finest-level codes of the SNAC program
EXPORT_KERNELS = ("lstm", "dilated_conv1d", "banded_conv1d", "quantized_matmul",
                  "depth_draft")
EXPORT_AUDIO_ATOL = 1e-5  # a loaded program's audio against the live port's
EXPORT_STREAM_ATOL = 1e-4  # the stateful Mimi chunks against the batch decode (JAX's)

_EXPORT_LOADER = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from mlx_audio_tpu_torch.export import load_program
from mlx_audio_tpu_torch.nn import kernels
# f32 means f32, as in the calling process: cuDNN convolutions default to TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
args = torch.load(sys.argv[3])
program = load_program(sys.argv[2])
kernels.reset_launches()
out = program(*args)
torch.cuda.synchronize()
torch.save([t.cpu() for t in out], sys.argv[4])
model_code = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "mlx_audio_tpu")
                    or m.startswith(tuple("mlx_audio_tpu_torch." + p for p in (
                        "models", "codec", "tts", "stt", "sts", "parallel"))))
print(json.dumps({"launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
                  "model_modules": model_code}))
"""


def _graph_nodes(program) -> int:
    return sum(len(m.graph.nodes) for m in program.modules()
               if isinstance(m, torch.fx.GraphModule))


def _exported(records, name, export_fn, path):
    """Export with ``export_fn(path)``, load ``path`` back; (program, the
    record: export and load seconds, artifact bytes, graph nodes, the
    kernels' op nodes)."""
    from mlx_audio_tpu_torch import export, ops

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_fn(path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = export.load_program(path)
    load_s = time.perf_counter() - t0
    record = {"export_s": round(export_s, 2), "load_s": round(load_s, 2),
              "bytes": Path(path).stat().st_size, "graph_nodes": _graph_nodes(program),
              "op_nodes": {k: v for k, v in ops.graph_ops(program).items() if v}}
    records[name] = record
    return program, record


def _exported_session(export_fn, prefix: Path):
    """``export_fn()`` writes ``<prefix>.prefill`` and ``.chunk`` and
    returns the export's info; both are loaded back and their files
    removed.  Returns (prefill, chunk, info, the record: export and load
    seconds, artifact bytes, graph nodes and op nodes of each)."""
    from mlx_audio_tpu_torch import export, ops

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = export_fn()
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    programs = {k: export.load_program(f"{prefix}.{k}") for k in ("prefill", "chunk")}
    load_s = time.perf_counter() - t0
    for k in programs:
        Path(f"{prefix}.{k}").unlink()
    rec = {"export_s": round(export_s, 2), "load_s": round(load_s, 2),
           "bytes": info["prefill_bytes"] + info["chunk_bytes"],
           "graph_nodes": {k: _graph_nodes(p) for k, p in programs.items()},
           "op_nodes": {k: {n: v for n, v in ops.graph_ops(p).items() if v}
                        for k, p in programs.items()}}
    return programs["prefill"], programs["chunk"], info, rec


def _kernel_launches(launches: dict, name: str) -> dict:
    return {k: launches[name][k] for k in EXPORT_KERNELS if launches[name][k]}


def _same_launches(launches: dict, live: str, prog: str, what: str) -> dict:
    a, b = _kernel_launches(launches, live), _kernel_launches(launches, prog)
    if a != b:
        fail(f"export {what}: the loaded program launched {b}, the live port {a}")
    return a


def _kokoro_export(launches, records, tmp: Path) -> tuple:
    """Kokoro-82M's program against ``synthesize_batch`` fed the same
    source draws; starts the fresh-process load and returns (its process,
    its start), which ``_kokoro_fresh`` reads."""
    from mlx_audio_tpu_torch import export
    from mlx_audio_tpu_torch.models.tts.kokoro import Model
    from mlx_audio_tpu_torch.models.tts.kokoro.istftnet import source_noise
    from mlx_audio_tpu_torch.models.tts.kokoro.presets import kokoro_82m_config

    model = Model(kokoro_82m_config(), device="cuda")
    path = tmp / "kokoro.pt2"
    program, rec = _exported(records, "kokoro", lambda p: export.export_kokoro(
        model, p, batch=1, phoneme_bucket=N_BUCKET, frame_bucket=F_BUCKET), path)
    phonemes = TEXT.split("\n")[0]
    toks = [0, *model.phonemes_to_ids(phonemes), 0]
    pack = np.random.default_rng(0).standard_normal((510, 1, 256)).astype(np.float32) * 0.1
    ref = pack[len(phonemes) - 1].reshape(1, -1)
    ids = torch.zeros((1, N_BUCKET), dtype=torch.int64, device="cuda")
    ids[0, :len(toks)] = torch.as_tensor(toks)
    draws = source_noise(1, model.SAMPLES_PER_FRAME * F_BUCKET,
                         model.decoder.generator.m_source.l_sin_gen.dim, "cuda", 0)
    args = (ids, torch.tensor([len(toks)], device="cuda"), torch.as_tensor(ref, device="cuda"),
            torch.full((1,), SPEED, device="cuda"), *draws)
    run = path_runner(launches, {})
    (live_audio, live_dur), = run("export_kokoro_live", lambda: model.synthesize_batch(
        [phonemes], ref, speeds=SPEED, buckets=(N_BUCKET, F_BUCKET), seed=0))
    audio, dur = run("export_kokoro_program", lambda: program(*args))
    n = len(live_audio)
    err = float(np.abs(audio[0, :n].cpu().numpy() - live_audio).max())
    same_dur = np.array_equal(dur[0, :len(toks)].cpu().numpy(), live_dur)
    if not same_dur or err > EXPORT_AUDIO_ATOL:
        fail(f"export kokoro: durations equal {same_dur}, audio {err:.3e} from "
             f"synthesize_batch's")
    per = _same_launches(launches, "export_kokoro_live", "export_kokoro_program", "kokoro")
    if per != rec["op_nodes"] or set(per) != set(KOKORO_KERNELS):
        fail(f"export kokoro: op nodes {rec['op_nodes']}, launches {per}")
    rec.update(audio_err=err, frames=int(live_dur.sum()), launches=per)
    # a fresh process that imports the op module and the loader only; it
    # runs while the other programs export, and _kokoro_fresh reads it
    torch.save(list(args), tmp / "kokoro_args.pt")
    torch.save(audio.cpu(), tmp / "kokoro_audio.pt")
    # its output to files: a pipe nobody reads while the rest runs could fill
    with open(tmp / "kokoro_fresh.out", "w") as out_f, \
            open(tmp / "kokoro_fresh.err", "w") as err_f:
        proc = subprocess.Popen([sys.executable, "-c", _EXPORT_LOADER, str(ROOT), str(path),
                                 str(tmp / "kokoro_args.pt"), str(tmp / "kokoro_out.pt")],
                                stdout=out_f, stderr=err_f)
    print(f"export kokoro: {json.dumps(rec)}", flush=True)
    return proc, time.perf_counter()


def _kokoro_fresh(records, tmp: Path, proc, t0: float) -> None:
    """The fresh process's launches and audio: the same launches, within
    EXPORT_AUDIO_ATOL of this process's run of the program (another
    process may pick other cuDNN algorithms for the library convs)."""
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode:
        fail(f"export kokoro: the fresh-process load failed: "
             f"{(tmp / 'kokoro_fresh.err').read_text()[-2000:]}")
    sub = json.loads((tmp / "kokoro_fresh.out").read_text().strip().splitlines()[-1])
    rec = records["kokoro"]
    sub_err = float((torch.load(tmp / "kokoro_out.pt")[0]
                     - torch.load(tmp / "kokoro_audio.pt")).abs().max())
    if sub["model_modules"] or sub["launches"] != rec["launches"] or sub_err > EXPORT_AUDIO_ATOL:
        fail(f"export kokoro: fresh process {sub}, audio {sub_err:.3e} from this one's")
    rec["fresh_process"] = {"launches": sub["launches"], "model_modules": 0,
                            "audio_err": sub_err,
                            "seconds": round(time.perf_counter() - t0, 2)}
    (tmp / "kokoro.pt2").unlink()
    print(f"export kokoro: fresh process {json.dumps(rec['fresh_process'])}", flush=True)


def build_export_csm():
    """CSM-1B at ``CSM_HF_CONFIG``'s widths (its Mimi whole), the backbone
    and depth decoder cut to EXPORT_LAYERS layers, seeded random weights,
    int8 in groups of 128, spec decode on."""
    from mlx_audio_tpu_torch.models.tts.sesame import Model
    from mlx_audio_tpu_torch.nn.quantize import quantize_model

    cfg = {**CSM_HF_CONFIG, "num_hidden_layers": EXPORT_LAYERS,
           "depth_decoder_config": {**CSM_HF_CONFIG["depth_decoder_config"],
                                    "num_hidden_layers": EXPORT_LAYERS}}
    model = Model(cfg, text_tokenizer=StubTokenizer(), device="cuda")
    quantize_model(model.model, group_size=128, bits=8)
    model.model.enable_spec_decode()
    return model


def _csm_export(launches, records, tmp: Path, model) -> None:
    """The int8 CSM with spec decode: the prefill and chunk programs
    against ``_prefill``, ``first_frame`` and ``_frame_chunk``."""
    from mlx_audio_tpu_torch import export
    from mlx_audio_tpu_torch.models.tts.sesame import Segment
    from mlx_audio_tpu_torch.models.tts.sesame.model import _prompt_bucket

    lm = model.model
    if not lm._use_spec(1):
        fail("export csm: spec decode is off")
    ref = (np.random.default_rng(0).standard_normal(48_000) * 0.1).astype(np.float32)
    prompt = model._prompt(CSM_TEXT, [Segment(0, CSM_REF_TEXT, ref)], 0, True)
    bucket = _prompt_bucket(prompt[0].shape[0])
    prefix = tmp / "csm"
    prefill, chunk, info, rec = _exported_session(lambda: export.export_csm_session(
        lm, str(prefix), prompt_bucket=bucket, max_frames=EXPORT_CSM_MAX,
        chunk_frames=EXPORT_CSM_CHUNK, temp=0.0, top_k=50), prefix)
    if rec["op_nodes"]["chunk"].get("depth_draft") != 1:
        fail(f"export csm: chunk op nodes {rec['op_nodes']['chunk']}")
    nc = lm.audio_num_codebooks
    pad = bucket - prompt[0].shape[0]
    tokens = torch.zeros((1, bucket, nc + 1), dtype=torch.int64, device="cuda")
    mask = torch.zeros((1, bucket, nc + 1), dtype=torch.bool, device="cuda")
    tokens[0, pad:] = torch.as_tensor(prompt[0])
    mask[0, pad:] = torch.as_tensor(prompt[1])
    pad_len = torch.tensor([pad], device="cuda")
    state = [torch.zeros(s, dtype=getattr(torch, d), device="cuda")
             for s, d in zip(info["cache_shapes"], info["cache_dtypes"])]
    noise = {k: torch.zeros(s, device="cuda") for k, s in info["noise_shapes"].items()}
    run = path_runner(launches, {})

    def live_prefill():
        caches, live_pad, last_h = model._prefill([prompt], EXPORT_CSM_MAX, bucket)
        return caches, live_pad, lm.first_frame(last_h, 0.0, 50, model.generator)

    caches, live_pad, first = run("export_csm_live_prefill", live_prefill)
    frames = run("export_csm_live_chunk", lambda: model._frame_chunk(
        caches, live_pad, first, EXPORT_CSM_CHUNK, 0.0, 50))
    pre = run("export_csm_program_prefill", lambda: prefill(tokens, mask, pad_len,
                                                            noise["prefill"], *state))
    out = run("export_csm_program_chunk", lambda: chunk(pre[0], pad_len, noise["chunk"],
                                                        *pre[1:]))
    if not (torch.equal(pre[0], first) and torch.equal(out[0], frames)):
        fail("export csm: the loaded programs' frames differ from the live decode's")
    per_chunk = _same_launches(launches, "export_csm_live_chunk", "export_csm_program_chunk",
                               "csm chunk")
    if set(per_chunk) != {"quantized_matmul", "depth_draft"}:
        fail(f"export csm: chunk launches {per_chunk}")
    prog_pre = _same_launches(launches, "export_csm_live_prefill",
                              "export_csm_program_prefill", "csm prefill")
    rec.update(layers=EXPORT_LAYERS, frames=1 + EXPORT_CSM_CHUNK, per_frame={
        k: v / EXPORT_CSM_CHUNK for k, v in per_chunk.items()}, prefill_launches=prog_pre)
    records["csm"] = rec
    print(f"export csm: {json.dumps(rec)}", flush=True)


def _mimi_export(launches, records, tmp: Path, mimi) -> None:
    from mlx_audio_tpu_torch import export

    nq = mimi.cfg.quantizer_nq
    n = max(EXPORT_MIMI_FRAMES, 3 * EXPORT_MIMI_CHUNK)
    codes = torch.as_tensor(np.random.default_rng(5).integers(
        0, mimi.cfg.quantizer_bins, (1, nq, n)), device="cuda")
    path = tmp / "mimi.pt2"
    program, rec = _exported(records, "mimi", lambda p: export.export_mimi_decode(
        mimi, p, frames=EXPORT_MIMI_FRAMES), path)
    batch_codes = codes[:, :, :EXPORT_MIMI_FRAMES]
    live = mimi.decode(batch_codes)
    got = program(batch_codes)
    err = float((got - live).abs().max())
    if err > EXPORT_AUDIO_ATOL:
        fail(f"export mimi: {err:.3e} from the live decode")
    rec["audio_err"] = err
    path.unlink()
    spath = tmp / "mimi_stream.pt2"
    t0 = time.perf_counter()
    info = export.export_mimi_stream_decode(mimi, spath, chunk_frames=EXPORT_MIMI_CHUNK)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = export.load_program(spath)
    load_s = time.perf_counter() - t0
    state = [torch.zeros(s, dtype=getattr(torch, d), device="cuda") if v == "zeros"
             else torch.full(s, v, dtype=getattr(torch, d), device="cuda")
             for s, d, v in zip(info["state_shapes"], info["state_dtypes"], info["state_init"])]
    chunks = []
    for i in range(3):
        out = step(codes[:, :, EXPORT_MIMI_CHUNK * i:EXPORT_MIMI_CHUNK * (i + 1)], *state)
        chunks.append(out[0])
        state = list(out[1:])
    stream = torch.cat(chunks, dim=-1)
    streamed = codes[:, :, :3 * EXPORT_MIMI_CHUNK]
    whole = mimi.decode(streamed)
    s_err = float((stream - whole).abs().max())
    f_err = float((stream - mimi.decode_frames(streamed)).abs().max())
    if s_err > EXPORT_STREAM_ATOL or f_err > EXPORT_AUDIO_ATOL:
        fail(f"export mimi stream: {s_err:.3e} from the batch decode, {f_err:.3e} from "
             f"the live frame-by-frame decode")
    records["mimi_stream"] = {
        "export_s": round(export_s, 2), "load_s": round(load_s, 2), "bytes": info["bytes"],
        "graph_nodes": _graph_nodes(step), "state_leaves": len(state),
        "batch_err": s_err, "frames_err": f_err, "audio_rms": float(whole.pow(2).mean().sqrt())}
    spath.unlink()
    print(f"export mimi: {json.dumps(records['mimi'])}; stream "
          f"{json.dumps(records['mimi_stream'])}", flush=True)


def _orpheus_export(launches, records, tmp: Path) -> None:
    from mlx_audio_tpu_torch import export
    from mlx_audio_tpu_torch.models.lm.causal import _bucket, generate_tokens_batch

    model = build_orpheus(EXPORT_LAYERS)
    lm = model.lm
    prompt_ids = np.random.default_rng(3).integers(1_000, 120_000, 20)
    bucket = _bucket(len(prompt_ids))
    max_tokens = 1 + 2 * EXPORT_TOKENS_CHUNK
    prefix = tmp / "orpheus"
    prefill, chunk, info, rec = _exported_session(lambda: export.export_causal_session(
        lm, str(prefix), prompt_bucket=bucket, max_tokens=max_tokens,
        chunk_tokens=EXPORT_TOKENS_CHUNK, temp=0.0), prefix)
    run = path_runner(launches, {})
    live = run("export_orpheus_live", lambda: generate_tokens_batch(
        lm, [prompt_ids], max_tokens=max_tokens, temperature=0.0,
        chunk=EXPORT_TOKENS_CHUNK)[0])
    prompt = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
    prompt[0, bucket - len(prompt_ids):] = torch.as_tensor(prompt_ids)
    pad_len = torch.tensor([bucket - len(prompt_ids)], device="cuda")
    state = [torch.zeros(s, dtype=getattr(torch, d), device="cuda")
             for s, d in zip(info["cache_shapes"], info["cache_dtypes"])]
    noise = {k: torch.zeros(s, device="cuda") for k, s in info["noise_shapes"].items()}

    def program_run():
        pre = prefill(prompt, pad_len, noise["prefill"], *state)
        toks, last, flat = [pre[0]], pre[0], list(pre[1:])
        for _ in range(2):
            out = chunk(last, pad_len, noise["chunk"], *flat)
            toks.append(out[0][:, 0])
            last, flat = out[0][-1], list(out[1:])
        return torch.cat(toks)

    got = run("export_orpheus_program", program_run).cpu().numpy()
    if not np.array_equal(got, live):
        fail(f"export orpheus: tokens {got.tolist()} against generate_tokens_batch's "
             f"{live.tolist()}")
    per = _same_launches(launches, "export_orpheus_live", "export_orpheus_program", "orpheus")
    rec.update(layers=EXPORT_LAYERS, tokens=int(len(live)),
               distinct=int(len(set(live.tolist()))),
               per_token={k: v / max_tokens for k, v in per.items()})
    if set(per) != {"quantized_matmul"}:
        fail(f"export orpheus: launches {per}")
    del prefill, chunk
    snac = model._snac
    spath = tmp / "snac.pt2"
    snac_prog, srec = _exported(records, "snac", lambda p: export.export_snac_decode(
        snac, p, frames=EXPORT_SNAC_FRAMES), spath)
    g = torch.Generator(device="cuda").manual_seed(2)
    codes = [torch.randint(0, snac.config.codebook_size, (1, EXPORT_SNAC_FRAMES // s),
                           generator=g, device="cuda") for s in snac.vq_strides]
    draws = [torch.randn(s, generator=g, device="cuda")
             for s in export.snac_noise_shapes(snac, EXPORT_SNAC_FRAMES)]
    s_err = float((snac_prog(*codes, *draws) - snac.decode(codes, noise=draws)).abs().max())
    if s_err > EXPORT_AUDIO_ATOL:
        fail(f"export snac: {s_err:.3e} from the live decode")
    srec["audio_err"] = s_err
    spath.unlink()
    records["orpheus"] = rec
    print(f"export orpheus: {json.dumps(rec)}; snac {json.dumps(srec)}", flush=True)


def _whisper_export(launches, records, tmp: Path) -> None:
    from mlx_audio_tpu_torch import export
    from mlx_audio_tpu_torch.models.stt.whisper import api
    from mlx_audio_tpu_torch.models.stt.whisper.audio import log_mel_spectrogram, pad_or_trim
    from mlx_audio_tpu_torch.models.stt.whisper.decoding import DecodingOptions

    model, tok = build_whisper({**WHISPER_DIMS, "n_audio_layer": EXPORT_LAYERS,
                                "n_text_layer": EXPORT_LAYERS})
    path = tmp / "whisper.pt2"
    meta = {}

    def do_export(p):
        meta.update(export.export_whisper_greedy(model, p, batch=1,
                                                 sample_len=WHISPER_SAMPLE_LEN))

    program, rec = _exported(records, "whisper", do_export, path)
    mel = pad_or_trim(log_mel_spectrogram(_clip(11, 30.0), n_mels=128, device="cuda"),
                      3000, axis=0)[None]
    run = path_runner(launches, {})
    live = run("export_whisper_live", lambda: api.decode(
        model, mel, DecodingOptions(language="en", temperature=0.0,
                                    sample_len=WHISPER_SAMPLE_LEN), tokenizer=tok))[0]
    toks, t_end, _, ns = run("export_whisper_program", lambda: program(mel))
    sb, eot = meta["finalize"]["sample_begin"], meta["finalize"]["eot"]
    seq = toks[0, sb:int(t_end)].tolist()
    if eot in seq:
        seq = seq[:seq.index(eot)]
    if seq != live.tokens or abs(float(ns[0]) - live.no_speech_prob) > 1e-6:
        fail(f"export whisper: {len(seq)} tokens against decode's {len(live.tokens)} "
             f"(equal {seq == live.tokens}), no-speech {float(ns[0])} / {live.no_speech_prob}")
    per = _same_launches(launches, "export_whisper_live", "export_whisper_program", "whisper")
    if per != {"dilated_conv1d": 1} or rec["op_nodes"] != per:
        fail(f"export whisper: launches {per}, op nodes {rec['op_nodes']}")
    rec.update(layers=EXPORT_LAYERS, tokens=len(seq), launches=per)
    path.unlink()
    print(f"export whisper: {json.dumps(rec)}", flush=True)


def export_runs(launches: dict, tmp: Path) -> dict:
    """Phase 18: every kind of ``mlx_audio_tpu_torch.export`` at published
    widths, each program exported, saved, loaded back and run on the card
    against the live port on the same inputs, its launches against the live
    run's."""
    records = {"seconds": {}}
    t0 = time.perf_counter()
    fresh = None
    try:
        csm = None
        for name in ("kokoro", "csm", "mimi", "orpheus", "whisper"):
            t = time.perf_counter()
            if name == "kokoro":
                fresh = _kokoro_export(launches, records, tmp)
            elif name == "csm":
                csm = build_export_csm()
                _csm_export(launches, records, tmp, csm)
            elif name == "mimi":
                _mimi_export(launches, records, tmp, csm.mimi)
                del csm
            elif name == "orpheus":
                _orpheus_export(launches, records, tmp)
            else:
                _whisper_export(launches, records, tmp)
            torch.cuda.empty_cache()
            records["seconds"][name] = round(time.perf_counter() - t, 1)
            print(f"export {name} took {records['seconds'][name]} s", flush=True)
        t = time.perf_counter()
        _kokoro_fresh(records, tmp, *fresh)
        records["seconds"]["kokoro_fresh_wait"] = round(time.perf_counter() - t, 1)
    finally:
        if fresh is not None and fresh[0].poll() is None:
            fresh[0].kill()
            fresh[0].wait()
    records["seconds"]["total"] = round(time.perf_counter() - t0, 1)
    return records


def export_worker(tmp: str) -> None:
    """Phase 18 in a process of its own (``start_export_worker``): the
    kernels as phase 1 built them, ``export_runs`` into ``tmp``, and its
    records and launches to ``tmp/records.json``.  A failure exits non-zero
    with its message on stderr."""
    # second to the main process on the host: its phases measure walls
    os.nice(10)
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = {}
    records = export_runs(launches, Path(tmp))
    with open(Path(tmp) / "records.json", "w") as f:
        json.dump({"records": records, "launches": launches}, f)


def start_export_worker(tmp: Path):
    """Start phase 18 beside the later phases: exporting is host work
    (tracing, about 6 ms a graph node, and writing the weights), which
    would otherwise add minutes to the script; its card work is a few
    seconds of model builds and program runs.  Its output goes to files
    in ``tmp``; the process is killed at exit if still running."""
    import atexit

    out = open(tmp / "worker.out", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "import chip_smoke; chip_smoke.export_worker(sys.argv[2])", str(ROOT), str(tmp)],
        stdout=out, stderr=subprocess.STDOUT)
    out.close()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return proc, time.perf_counter()


def join_export_worker(worker, tmp: Path, launches: dict) -> dict:
    """Wait for phase 18's process, fail with its log's tail if it failed,
    print its log, and merge its launches into ``launches``."""
    proc, t0 = worker
    try:
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log = (tmp / "worker.out").read_text()
    lines = [ln for ln in log.splitlines() if ln.startswith("export ")]
    print("\n".join(lines), flush=True)
    if proc.returncode:
        fail(f"phase 18 (export) failed: {log[-3000:]}")
    out = json.loads((tmp / "records.json").read_text())
    launches.update(out["launches"])
    out["records"]["seconds"]["worker_wall"] = round(time.perf_counter() - t0, 1)
    return out["records"]

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port, and the kernel sources it builds, come from this checkout
    sys.path.insert(0, str(ROOT))
    try:
        from mlx_audio_tpu_torch.nn import kernels
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    if ROOT not in Path(kernels.__file__).resolve().parents:
        print(f"chip_smoke: the port was imported from {kernels.__file__}, "
              f"not from the checkout at {ROOT}", file=sys.stderr)
        return 2
    from mlx_audio_tpu_torch.models.tts.kokoro import Model
    from mlx_audio_tpu_torch.models.tts.kokoro.presets import kokoro_82m_config

    t_start = time.perf_counter()
    card = gpu_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    # f32 means f32: cuDNN convolutions default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # seconds from the start to each phase's start, printed before the kernels line
    starts = {}

    def phase_start(n):
        starts[n] = round(time.perf_counter() - t_start, 1)

    phase_start(1)
    build_kernels()
    phase_start(2)
    records = check_kernels()
    launches = {}
    drive_probes(launches)

    phase_start(3)
    model = Model(kokoro_82m_config(), device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        voice = str(Path(tmp) / "voice.npy")
        pack = np.random.default_rng(0).standard_normal((510, 1, 256)) * 0.1
        np.save(voice, pack.astype(np.float32))
        kernels.reset_launches()
        with torch.no_grad():
            drive_entry_points(model, voice)
        launches["entry_points"] = dict(kernels.LAUNCHES)
        lstm_routes = {"entry_points": dict(kernels.LSTM_ROUTE_LAUNCHES)}

    run_once = bench_runner(model)
    kernels.reset_launches()
    bench = bench_pass(run_once)
    launches["bench"] = dict(kernels.LAUNCHES)
    lstm_routes["bench"] = dict(kernels.LSTM_ROUTE_LAUNCHES)
    per_call = {k: v // bench["calls"] for k, v in launches["bench"].items()}
    for phase in ("entry_points", "bench"):
        missing = [k for k in KOKORO_KERNELS if launches[phase][k] == 0]
        if missing:
            fail(f"phase {phase}: kernels never launched: {missing}")
        # Kokoro-82M's LSTMs are all H = 256: the cluster route
        if lstm_routes[phase]["row"] or not lstm_routes[phase]["cluster"]:
            fail(f"phase {phase}: lstm launches by route {lstm_routes[phase]}")
    print(f"launches: {json.dumps(launches)}; per bench synthesis call "
          f"{json.dumps(per_call)}; lstm by route "
          f"{json.dumps(lstm_routes)}")
    print(f"bench pass (batch {BENCH_BATCH}, {N_BUCKET} phonemes, "
          f"{F_BUCKET} frames, f32): "
          f"{bench['audio_seconds_per_second']:.2f} audio-s/s, median "
          f"{bench['median_s']:.4f} s per iteration, "
          f"{bench['audio_seconds_per_iter']:.1f} audio-s per iteration, "
          f"(duration stage {bench['duration_stage_s']:.4f} s, synthesis "
          f"stage {bench['synthesis_stage_s']:.4f} s; iterations "
          f"{', '.join(f'{t:.4f}' for t in bench['iter_s'])} s), peak {bench['peak_memory_gb']:.2f} GB, on {card}")
    profile_pass(run_once)
    del model, run_once
    torch.cuda.empty_cache()

    # phase 18 runs in a process of its own beside phases 5-17
    export_tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_export_"))
    export_worker = start_export_worker(export_tmp)

    phase_start(5)
    csm = build_csm()
    csm_run = csm_runs(csm, launches)
    csm_breakdown(csm)
    csm_stream_breakdown(csm)
    csm_phases = [k for k in launches if k.startswith("csm_")]
    csm_bf16 = csm_bf16_runs(csm, launches, csm_run)
    print(f"csm launches: {json.dumps({k: launches[k] for k in csm_phases})}; "
          f"per spec-decode frame: " + json.dumps({
              k: launches["csm_generate_spec"][k] / CSM_FRAMES
              for k in ("quantized_matmul", "depth_draft")})
          + "; in bf16: " + json.dumps({
              k: launches["csm_bf16_generate_spec"][k] / CSM_FRAMES
              for k in ("quantized_matmul_bf16", "depth_draft")}), flush=True)

    del csm
    torch.cuda.empty_cache()

    phase_start(6)
    orpheus = build_orpheus()
    orpheus_run = orpheus_runs(orpheus, launches)
    orpheus_info = orpheus_breakdown(orpheus)
    orpheus_bf16 = orpheus_bf16_runs(orpheus, launches, orpheus_run)
    del orpheus
    torch.cuda.empty_cache()
    dac_runs(launches)
    per_token = launches["orpheus_generate"]["quantized_matmul"] / ORPHEUS_TOKENS
    per_dac = {k: launches["dac_encode_decode"][k] for k in ("banded_conv1d", "dilated_conv1d")}
    phase6 = {k: v for k, v in launches.items() if k.startswith(("orpheus_", "dac_"))}
    print(f"phase 6 launches: {json.dumps(phase6)}; "
          f"quantized_matmul per Orpheus token {per_token:.2f}; per DAC encode and "
          f"decode of {DAC_SECONDS} s {json.dumps(per_dac)}; Orpheus {json.dumps(orpheus_info)}"
          f"; Orpheus bf16 {json.dumps(orpheus_bf16)}", flush=True)

    phase_start(7)
    outetts = build_outetts()
    outetts_run = outetts_runs(outetts, launches)
    outetts_info = outetts_breakdown(outetts)
    outetts_bf16 = outetts_bf16_runs(outetts, launches, outetts_run)
    del outetts
    torch.cuda.empty_cache()
    dia = build_dia()
    dia_run = dia_runs(dia, launches)
    dia_info = dia_breakdown(dia, dia_run["codes"])
    dia_err = dia_card_against_cpu(dia, dia_run["codes"])
    dia_bf16 = dia_bf16_runs(dia, launches, dia_run)
    del dia
    torch.cuda.empty_cache()
    per_outetts_token = launches["outetts_generate"]["quantized_matmul"] / OUTETTS_TOKENS
    per_dac_call = {path: {k: launches[f"{path}_generate"][k]
                           for k in ("banded_conv1d", "dilated_conv1d")}
                    for path in ("outetts", "dia")}
    phase7 = {k: v for k, v in launches.items() if k.startswith(("outetts_", "dia_"))}
    print(f"phase 7 launches: {json.dumps(phase7)}; quantized_matmul per OuteTTS token "
          f"{per_outetts_token:.2f}; per DAC decode of a greedy generate "
          f"{json.dumps(per_dac_call)}; OuteTTS {json.dumps(outetts_info)}; OuteTTS bf16 "
          f"{json.dumps(outetts_bf16)}; Dia "
          f"{json.dumps(dia_info)}, generate's real-time factor "
          f"{dia_run['real_time_factor']:.4f}, teacher-forced logits against the CPU "
          f"{dia_err:.3e}; Dia bf16 {json.dumps(dia_bf16)}", flush=True)

    # phase 8: EnCodec-24kHz, Bark (decoding through that EnCodec) and Vocos
    phase_start(8)
    lstm_routes8 = {}
    codec = build_encodec()
    encodec_run = encodec_runs(codec, launches, lstm_routes8)
    bark = build_bark(codec)
    bark_run = bark_runs(bark, launches, lstm_routes8)
    bark_info = bark_breakdown(bark, bark_run)
    bark_err = bark_card_against_cpu(bark, bark_run)
    encodec_bf16 = encodec_bf16_runs(codec, launches, lstm_routes8)
    bark_bf16 = bark_bf16_runs(bark, launches, lstm_routes8, bark_run, bark_info)
    del bark, codec
    torch.cuda.empty_cache()
    vocos_run = vocos_runs(launches)
    phase8 = {k: v for k, v in launches.items() if k.startswith(("encodec_", "bark_", "vocos_"))}
    per_encodec = launches["encodec_encode_decode"]["lstm"]
    per_bark = launches["bark_generate"]["lstm"]
    print(f"phase 8 launches: {json.dumps(phase8)}; EnCodec bf16 {json.dumps(encodec_bf16)}; "
          f"Bark bf16 {json.dumps(bark_bf16)}; "
          f"lstm by route "
          f"{json.dumps(lstm_routes8)}; lstm per EnCodec encode and decode of "
          f"{ENCODEC_SECONDS} s {per_encodec}, per Bark generate {per_bark}; Bark "
          f"{json.dumps(bark_info)}, generate's real-time factor "
          f"{bark_run['real_time_factor']:.4f}, teacher-forced logits against the CPU "
          f"{bark_err:.3e}; EnCodec {json.dumps(encodec_run['wall'])}; Vocos "
          f"{json.dumps(vocos_run['wall'])}", flush=True)

    # phase 9: Spark-TTS-0.5B (int8 LM, BiCodec, wav2vec2-large-xlsr-53)
    phase_start(9)
    spark = build_spark()
    spark_run = spark_runs(spark, launches)
    spark_tok = spark_tokenize_against_cpu(spark, spark_run)
    spark_info = spark_breakdown(spark, spark_run)
    spark_err = spark_card_against_cpu(spark, spark_run)
    spark_bf16 = spark_bf16_runs(spark, launches, spark_run)
    del spark
    torch.cuda.empty_cache()
    phase9 = {k: v for k, v in launches.items() if k.startswith("spark_")}
    per_spark_token = launches["spark_generate"]["quantized_matmul"] / SPARK_TOKENS
    per_spark_detok = {k: launches["spark_generate"][k]
                       for k in ("banded_conv1d", "dilated_conv1d")}
    print(f"phase 9 launches: {json.dumps(phase9)}; quantized_matmul per Spark token "
          f"{per_spark_token:.2f}; per BiCodec detokenize of a greedy generate "
          f"{json.dumps(per_spark_detok)}; Spark {json.dumps(spark_info)}, generate's "
          f"real-time factor {spark_run['real_time_factor']:.4f}, tokenize against the CPU "
          f"{json.dumps(spark_tok)}, teacher-forced logits against the CPU "
          f"{spark_err:.3e}; Spark bf16 {json.dumps(spark_bf16)}", flush=True)

    # phase 10: Whisper-large-v3-turbo (f32) and Voxtral-Mini-3B (int8 LM)
    phase_start(10)
    whisper, wtok = build_whisper()
    whisper_run = whisper_runs(whisper, wtok, launches)
    whisper_cpu = whisper_card_against_cpu(whisper, wtok, whisper_run)
    whisper_info = whisper_breakdown(whisper, whisper_run)
    whisper_bf16 = whisper_bf16_runs(whisper, wtok, launches, whisper_run, whisper_info)
    del whisper
    torch.cuda.empty_cache()
    voxtral = build_voxtral()
    voxtral_run = voxtral_runs(voxtral, launches)
    voxtral_info = voxtral_breakdown(voxtral, voxtral_run)
    voxtral_bf16 = voxtral_bf16_runs(voxtral, launches, voxtral_run)
    del voxtral
    torch.cuda.empty_cache()
    phase10 = {k: v for k, v in launches.items() if k.startswith(("whisper_", "voxtral_"))}
    per_voxtral_token = ((launches["voxtral_generate"]["quantized_matmul"] - 1)
                         / (VOXTRAL_TOKENS - 1))
    print(f"phase 10 launches: {json.dumps(phase10)}; encodes {json.dumps(whisper_run['encodes'])}"
          f"; quantized_matmul per Voxtral decode step {per_voxtral_token:.2f}; Whisper "
          f"{json.dumps(whisper_info)}, generate's real-time factor "
          f"{whisper_run['real_time_factor']:.4f}, peak {whisper_run['peak_memory_gb']:.2f} GB, "
          f"against the CPU {json.dumps(whisper_cpu)}; Whisper bf16 {json.dumps(whisper_bf16)}; "
          f"Voxtral {json.dumps(voxtral_info)}, "
          f"generate's real-time factor {voxtral_run['real_time_factor']:.4f}, peak "
          f"{voxtral_run['peak_memory_gb']:.2f} GB"
          f"; Voxtral bf16 {json.dumps(voxtral_bf16)}", flush=True)

    # phase 11: Parakeet-TDT-0.6B-v2 and BigVGAN-v2-24kHz-100band (f32)
    phase_start(11)
    parakeet, parakeet_ctc = build_parakeet()
    parakeet_run = parakeet_runs(parakeet, parakeet_ctc, launches)
    parakeet_cpu = parakeet_card_against_cpu(parakeet, parakeet_ctc, parakeet_run)
    parakeet_info = parakeet_breakdown(parakeet, parakeet_run)
    parakeet_bf16 = parakeet_bf16_runs(parakeet, parakeet_ctc, launches, parakeet_run,
                                       parakeet_info)
    del parakeet, parakeet_ctc
    torch.cuda.empty_cache()
    bigvgan = build_bigvgan()
    bigvgan_run = bigvgan_runs(bigvgan, launches)
    bigvgan_info = bigvgan_breakdown(bigvgan, bigvgan_run)
    bigvgan_err = bigvgan_card_against_cpu(bigvgan, bigvgan_run)
    bigvgan_bf16 = bigvgan_bf16_runs(bigvgan, launches, bigvgan_run,
                                     bigvgan_info["forward_ms_batch1"])
    del bigvgan
    torch.cuda.empty_cache()
    phase11 = {k: v for k, v in launches.items() if k.startswith(("parakeet_", "bigvgan_"))}
    print(f"phase 11 launches: {json.dumps(phase11)}; Parakeet {json.dumps(parakeet_info)}, "
          f"generate's real-time factor {parakeet_run['real_time_factor']:.4f}, peak "
          f"{parakeet_run['peak_memory_gb']:.2f} GB, against the CPU {json.dumps(parakeet_cpu)}; "
          f"Parakeet bf16 {json.dumps(parakeet_bf16)}; "
          f"BigVGAN {json.dumps(bigvgan_info)}, peak {bigvgan_run['peak_memory_gb']:.2f} GB, "
          f"audio against the CPU {bigvgan_err:.3e}; BigVGAN bf16 {json.dumps(bigvgan_bf16)}; "
          f"on {card}", flush=True)

    # phase 12: IndexTTS-1.5 (f32)
    phase_start(12)
    t12 = time.perf_counter()
    indextts = build_indextts()
    indextts_run = indextts_runs(indextts, launches)
    indextts_info = indextts_breakdown(indextts, indextts_run)
    indextts_cpu = indextts_card_against_cpu(indextts, indextts_run)
    indextts_bf16 = indextts_bf16_runs(indextts, launches, indextts_run, indextts_info)
    del indextts
    torch.cuda.empty_cache()
    phase12 = {k: v for k, v in launches.items() if k.startswith("indextts_")}
    print(f"phase 12 launches: {json.dumps(phase12)}; IndexTTS {json.dumps(indextts_info)}, "
          f"peak {indextts_run['peak_memory_gb']:.2f} GB, against the CPU "
          f"{json.dumps(indextts_cpu)}; IndexTTS bf16 {json.dumps(indextts_bf16)}; phase 12 "
          f"took {time.perf_counter() - t12:.1f} s; "
          f"on {card}", flush=True)

    # phase 13: Kokoro-82M in bf16 at bench.py's shape and dtype; phases
    # 14 and 17's workers start, in phases 14-17's directory, and set up
    # beside its path checks; its bench waits for them, so that their
    # start-up overlaps no timed work
    phase_start(13)
    t13 = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    voice = str(Path(tmp) / "voice.npy")
    np.save(voice, pack.astype(np.float32))
    kdir = str(Path(tmp) / "Kokoro-82M")
    workers = {"prewarm": start_prewarm_worker(kdir, voice, Path(tmp)),
               "processes": start_process_workers(kdir, voice, Path(tmp))}
    (proc, paths), (procs, readies, work) = workers["prewarm"], workers["processes"]
    ready = {}

    def wait_workers():
        ready["wait_s"] = wait_ready([(proc, paths["ready"], paths["log"])]
                                     + [(p, r, work / f"log{i}") for i, (p, r) in
                                        enumerate(zip(procs, readies))], WORKER_READY_S)

    kokoro_bf16 = kokoro_bf16_runs(launches, bench, voice, wait_workers)
    torch.cuda.empty_cache()
    bf16_per_call = {k: v // kokoro_bf16["bench"]["calls"]
                     for k, v in launches["kokoro_bf16_bench"].items()}
    print(f"phase 13 launches: {json.dumps({k: launches[k] for k in launches if k.startswith('kokoro_bf16')})}"
          f"; per bench synthesis call {json.dumps({k: v for k, v in bf16_per_call.items() if v})}"
          f"; generate against the CPU {json.dumps(kokoro_bf16['against_cpu'])}; phase 13 took "
          f"{time.perf_counter() - t13:.1f} s; on {card}", flush=True)

    # phase 14: the entry points: native checkpoints, the TTS CLI, the server
    phase_start(14)
    t14 = time.perf_counter()
    with tmp_dir:
        entry_out, ckpts = entry_point_runs(launches, per_call, voice, Path(tmp))
        entry_out["prewarm"] = kokoro_prewarm_runs(launches, workers["prewarm"])
        entry_out["workers_ready_wait_s"] = ready["wait_s"]
        phase14 = {k: launches[k] for k in launches if k.startswith("serve_")}
        print(f"phase 14 launches: {json.dumps(phase14)}; entry points "
              f"{json.dumps(entry_out)}; phase 14 took {time.perf_counter() - t14:.1f} s; "
              f"on {card}", flush=True)

        # phase 15: a speech-to-speech session on phase 14's checkpoints
        phase_start(15)
        t15 = time.perf_counter()
        sts = sts_session_runs(launches, ckpts, voice, Path(tmp))
        print(f"phase 15: {json.dumps({k: v for k, v in sts.items() if k != 'turns'})}; "
              f"phase 15 took {time.perf_counter() - t15:.1f} s; on {card}", flush=True)

        # phase 16: an HF-transformers CSM-1B directory, Mimi's loaders,
        # SilentCipher and the S3 speech tokenizers
        phase_start(16)
        t16 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp16:
            csm_hf = csm_hf_runs(launches, Path(tmp16), csm_run)
            silentcipher = silentcipher_runs(csm_hf, Path(tmp16))
            del csm_hf["audio"]
            torch.cuda.empty_cache()
            s3 = s3_runs(launches, Path(tmp16))
        csm_model = csm_hf.pop("model")
        phase16 = {k: launches[k] for k in PHASE16_RUNS}
        print(f"phase 16 launches: {json.dumps(phase16)}; csm hf {json.dumps(csm_hf)}; "
              f"silentcipher {json.dumps(silentcipher)}; s3 {json.dumps(s3)}; phase 16 "
              f"took {time.perf_counter() - t16:.1f} s; on {card}", flush=True)

        # phase 17: the mesh on one card: phase 16's CSM-1B and phase 14's
        # Kokoro-82M checkpoint sharded over [cuda:0] x 4, the server's --mesh
        phase_start(17)
        mesh = mesh_runs(launches, csm_model, kdir, voice, Path(tmp), workers["processes"])
        phase17 = {k: launches[k] for k in MESH_RUNS}
        print(f"phase 17 launches: {json.dumps(phase17)}; mesh {json.dumps(mesh)}; "
              f"phase 17 took {mesh['seconds']:.1f} s; on {card}", flush=True)

        del csm_model
        torch.cuda.empty_cache()

    # phase 18: export.py, from its process started after phase 4
    phase_start(18)
    t18 = time.perf_counter()
    exported = join_export_worker(export_worker, export_tmp, launches)
    shutil.rmtree(export_tmp, ignore_errors=True)
    print(f"phase 18: {json.dumps(exported)}; its process took "
          f"{exported['seconds']['total']:.1f} s beside phases 5-17, phase 18 waited "
          f"{time.perf_counter() - t18:.1f} s for it; on {card}", flush=True)

    kernel_line = []
    for name, (source, replaces) in KERNEL_INFO.items():
        cases = records[name]
        head = max(cases, key=lambda r: r["bound_ms"])
        # each kernel's launches on its first path (Kokoro's, in float32 or
        # bf16, CSM's or the probes'), as before phase 6; Orpheus's, DAC's,
        # OuteTTS's, Dia's, EnCodec's, Bark's and Spark's apart below
        main = (("entry_points", "bench") if name in KOKORO_KERNELS
                else ("kokoro_bf16_path", "kokoro_bf16_bench") if name in KOKORO_BF16_KERNELS
                else ("probes_int8", "probes_bf16") if name in PROBE_KERNELS
                else csm_phases)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(launches[p][name] for p in (*main, *PHASE16_RUNS)),
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "shape": head["shape"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "cases": len(cases),
            **{k: head[k] for k in ("bound_f32_fma_ms", "max_abs_err_f64",
                                    "plain_max_abs_err_f64", "sync_only_ms")
               if k in head},
        }
        if name == "quantized_matmul_bf16":
            lm_bf16 = {"csm": csm_bf16, "orpheus": orpheus_bf16, "outetts": outetts_bf16,
                       "spark": spark_bf16, "voxtral": voxtral_bf16}
            entry["launches"] = sum(launches[p][name] for p in BF16_LM_RUNS)
            entry["max_bf16_steps"] = max([r["bf16_steps"] for r in cases]
                                          + [v["qmm_path_steps"] for v in lm_bf16.values()])
            entry["max_abs_err"] = max([entry["max_abs_err"]]
                                       + [v["qmm_path_err"] for v in lm_bf16.values()])
            entry["path_shapes"] = sum(v["qmm_path_shapes"] for v in lm_bf16.values())
            entry["launches_per_spec_frame"] = (
                launches["csm_bf16_generate_spec"][name] / CSM_FRAMES)
            for fam, n in (("orpheus", ORPHEUS_TOKENS), ("outetts", OUTETTS_TOKENS),
                           ("spark", SPARK_TOKENS)):
                entry[f"launches_per_{fam}_token"] = launches[f"{fam}_bf16_generate"][name] / n
            entry["launches_per_voxtral_token"] = (launches["voxtral_bf16_generate"][name]
                                                   / (VOXTRAL_TOKENS - 1))
            kernel_line.append(entry)
            continue
        if name in KOKORO_BF16_KERNELS:
            entry["max_bf16_steps"] = max(r["bf16_steps"] for r in cases)
            entry["launches_per_synthesis"] = bf16_per_call[name]
            entry["bench_batch"] = BF16_BENCH_BATCH
            entry["path_shapes"] = kokoro_bf16["path_shapes"].get(name, 0)
            if name == "lstm_bf16":
                entry["max_abs_err"] = max(entry["max_abs_err"], kokoro_bf16["lstm_path_err"],
                                           encodec_bf16["lstm_path_err"],
                                           bark_bf16["lstm_path_err"])
                entry["launches_per_encodec_encode_decode"] = launches[
                    "encodec_bf16_encode_decode"][name]
                entry["launches_per_bark_generate"] = launches["bark_bf16_generate"][name]
            else:
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           kokoro_bf16["conv_path_err"].get(name, 0.0),
                                           bigvgan_bf16["conv_path_err"].get(name, 0.0),
                                           dia_bf16["conv_path_err"].get(name, 0.0),
                                           whisper_bf16["conv_path_err"].get(name, 0.0))
                entry["launches_per_bigvgan_forward"] = launches["bigvgan_bf16_forward"][name]
                entry["launches_per_dia_dac_call"] = launches["dia_bf16_generate"][name]
                if name == "dilated_conv1d_bf16":
                    entry["launches_per_whisper_encode"] = launches["whisper_bf16_encode"][name]
            kernel_line.append(entry)
            continue
        if name in ("quantized_matmul", "depth_draft"):
            entry["launches_per_csm_hf_spec_frame"] = csm_hf["per_frame"][name]
        if name == "dilated_conv1d":
            entry["launches_per_s3_v1_encode"] = launches["s3_v1_encode"][name]
            entry["max_abs_err"] = max(entry["max_abs_err"], s3["conv_path_err"][name])
        if name == "quantized_matmul":
            entry["max_abs_err"] = max(entry["max_abs_err"], csm_run["qmm_path_err"],
                                       orpheus_run["qmm_path_err"],
                                       outetts_run["qmm_path_err"], csm_hf["qmm_path_err"])
            entry["path_shapes"] = (csm_run["qmm_path_shapes"] + csm_hf["qmm_path_shapes"]
                                    + orpheus_run["qmm_path_shapes"]
                                    + outetts_run["qmm_path_shapes"])
            entry["max_abs_err"] = max(entry["max_abs_err"], spark_run["qmm_path_err"])
            entry["path_shapes"] += spark_run["qmm_path_shapes"]
            entry["launches_per_orpheus_token"] = per_token
            entry["launches_per_outetts_token"] = per_outetts_token
            entry["launches_per_spark_token"] = per_spark_token
            entry["max_abs_err"] = max(entry["max_abs_err"], voxtral_run["qmm_path_err"])
            entry["path_shapes"] += voxtral_run["qmm_path_shapes"]
            entry["launches_per_voxtral_token"] = per_voxtral_token
        if name == "lstm":
            entry["max_abs_err"] = max(entry["max_abs_err"], encodec_run["lstm_path_err"],
                                       bark_run["lstm_path_err"])
            entry["path_shapes"] = (encodec_run["lstm_path_shapes"]
                                    + bark_run["lstm_path_shapes"])
            entry["launches_per_encodec_encode_decode"] = per_encodec
            entry["launches_per_bark_generate"] = per_bark
            entry["row_route_cases"] = [
                {k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "max_abs_err")}
                for r in cases if "route row" in r["shape"]]
        if name in KOKORO_KERNELS:
            entry["launches_per_synthesis"] = per_call[name]
            server = entry_out["tts"]
            entry["max_abs_err"] = max(entry["max_abs_err"], server["lstm_path_err"]
                                       if name == "lstm" else server["conv_path_err"][name])
            entry["server_batch_shapes"] = server["path_shapes"][name]
        elif name not in PROBE_KERNELS:
            entry["launches_per_spec_frame"] = (
                launches["csm_generate_spec"][name] / CSM_FRAMES)
        if name in per_dac:
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       outetts_run["conv_path_err"][name],
                                       dia_run["conv_path_err"][name])
            entry["path_shapes"] = (outetts_run["conv_path_shapes"][name]
                                    + dia_run["conv_path_shapes"][name])
            entry["launches_per_dac_call"] = per_dac[name]
            entry["launches_per_outetts_dac_call"] = per_dac_call["outetts"][name]
            entry["launches_per_dia_dac_call"] = per_dac_call["dia"][name]
            entry["max_abs_err"] = max(entry["max_abs_err"], spark_run["conv_path_err"][name])
            entry["path_shapes"] += spark_run["conv_path_shapes"][name]
            entry["launches_per_spark_detokenize"] = per_spark_detok[name]
            if name == "dilated_conv1d":
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           whisper_run["conv_path_err"][name],
                                           voxtral_run["conv_path_err"][name])
                entry["path_shapes"] += (whisper_run["conv_path_shapes"][name]
                                         + voxtral_run["conv_path_shapes"][name])
                entry["launches_per_whisper_encode"] = (
                    launches["whisper_decode_batch"][name]
                    / whisper_run["encodes"]["whisper_decode_batch"])
                entry["launches_per_voxtral_encode"] = launches["voxtral_generate"][name]
            entry["max_abs_err"] = max(entry["max_abs_err"], bigvgan_run["conv_path_err"][name])
            entry["path_shapes"] += bigvgan_run["conv_path_shapes"][name]
            entry["launches_per_bigvgan_forward"] = launches["bigvgan_forward"][name]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       indextts_run["conv_path_err"][name],
                                       indextts_bf16["conv_path_err"][name])
            entry["path_shapes"] += indextts_run["conv_path_shapes"][name]
            entry["launches_per_indextts_vocoder_call"] = launches["indextts_generate"][name]
            # the bf16 IndexTTS's vocoder runs in float32 by promotion
            entry["launches_per_indextts_bf16_vocoder_call"] = launches[
                "indextts_bf16_generate"][name]
        kernel_line.append(entry)
    # phase 17: the mesh runs' launches and path errors
    for entry in kernel_line:
        name = entry["name"]
        if name == "quantized_matmul":
            runs = mesh["csm"]
            entry["launches_per_mesh_csm_frame"] = {k: v["qmm_per_frame"]
                                                    for k, v in runs.items()}
            entry["mesh_shard_shapes"] = sorted({tuple(s) for v in runs.values()
                                                 for s in v.get("new_shapes", [])})
            entry["max_abs_err"] = max([entry["max_abs_err"]]
                                       + [v["qmm_path_err"] for v in runs.values()])
        elif name in KOKORO_KERNELS:
            kok = mesh["kokoro"]
            entry["launches_mesh_kokoro_dp4"] = launches["mesh_kokoro_dp4"][name]
            entry["launches_mesh_kokoro_processes"] = [
                launches[f"mesh_kokoro_process{p}"][name] for p in range(MESH_PROCESSES)]
            entry["launches_kokoro_prewarm"] = launches["kokoro_prewarm_prewarm"][name]
            entry["max_abs_err"] = max(entry["max_abs_err"], kok["lstm_path_err"]
                                       if name == "lstm" else kok["conv_path_err"][name])
    # the speech-to-speech session's launches a turn (the last through the
    # WebRTC bridge), and its path errors
    for entry in kernel_line:
        name = entry["name"]
        per_turn = [launches[f"sts_turn_{i}"][name] for i in range(STS_TURNS + 1)]
        if any(per_turn):
            entry["launches_per_sts_turn"] = per_turn
            entry["max_abs_err"] = max(entry["max_abs_err"], sts["lstm_path_err"]
                                       if name.startswith("lstm")
                                       else sts["conv_path_err"].get(name, 0.0))
    # phase 18: each kernel's launches in the exported programs' runs
    for entry in kernel_line:
        per = {k.removeprefix("export_"): launches[k][entry["name"]] for k in launches
               if k.startswith("export_") and "_program" in k and launches[k][entry["name"]]}
        if per:
            entry["launches_exported_programs"] = per
    phase_start(19)
    print(f"phase starts (s from the start): {json.dumps(starts)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernel_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
