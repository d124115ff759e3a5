# Copy of repro/data/__init__.py; the port imports nothing of repro.
from repro_torch.data.pipeline import LakeDataLoader
from repro_torch.data.synth import write_synth_corpus

__all__ = ["LakeDataLoader", "write_synth_corpus"]
