from torch_tts_tpu_torch.models.tacotron.model import Tacotron, build_tacotron

__all__ = ["Tacotron", "build_tacotron"]
