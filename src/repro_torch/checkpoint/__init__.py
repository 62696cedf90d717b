from .bridge import params_from_numpy, params_to_numpy
from .npz import (CheckpointError, checkpoint_crc, load_pytree, restore,
                  save, save_pytree)

__all__ = ["CheckpointError", "checkpoint_crc", "load_pytree",
           "params_from_numpy", "params_to_numpy", "restore", "save",
           "save_pytree"]
