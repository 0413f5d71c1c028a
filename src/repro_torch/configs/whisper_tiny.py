"""Whisper-tiny's backbone [arXiv:2212.04356].

4 + 4 layers, d_model=384 6H (kv=6) d_ff=1536 vocab=51865, encoder-decoder;
the conv / mel frontend is a stub (the caller supplies 1,500 frame
embeddings). The reduced config's head_dim is 24, which the flash kernel
does not take: it runs on the CPU only.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.whisper import WhisperConfig

ARCH_ID = "whisper-tiny"


def full() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID, kind="whisper", family="audio", citation="arXiv:2212.04356",
        whisper=WhisperConfig(
            name=ARCH_ID, vocab=51865, d_model=384, n_layers=4,
            n_heads=6, n_kv=6, d_ff=1536, n_audio_frames=1500,
        ),
        sub_quadratic=False,
        notes="decode_32k exercises the decoder cache beyond the trained "
              "448-token context (lowering/sharding exercise, see DESIGN.md).",
    )


def reduced() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID + "-smoke", kind="whisper", family="audio",
        citation="arXiv:2212.04356",
        whisper=WhisperConfig(
            name=ARCH_ID + "-smoke", vocab=512, d_model=96, n_layers=2,
            n_heads=4, n_kv=4, d_ff=192, n_audio_frames=32,
            dtype="float32", remat=False,
        ),
        sub_quadratic=False,
    )
