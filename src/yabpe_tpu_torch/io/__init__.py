"""Model serialization: native latin-1 dialect and GPT-2 unicode-remap dialect."""

from yabpe_tpu_torch.io.native import load_model, save_model

__all__ = ["load_model", "save_model"]
