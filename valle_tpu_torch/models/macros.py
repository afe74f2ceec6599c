"""Global vocabulary constants (mirror of ``valle_tpu/models/macros.py``)."""

NUM_TEXT_TOKENS = 512

# EnCodec residual-vector-quantizer bins per quantizer stage.
NUM_AUDIO_TOKENS = 1024

NUM_MEL_BINS = 100  # BigVGAN-compatible mel features

NUM_SPEAKER_CLASSES = 4096
SPEAKER_EMBEDDING_DIM = 64
