"""The port's train CLI with the ICV rows set from a saved array.

``python tests/torch_train_from_init.py key=val ...`` (also under
``python -m torch.distributed.run``) runs ``licv_vqa_tpu_torch.cli.train``
with every ``GlobalICVEncoder`` it builds starting from the (L, D) array
in the ``.npy`` file that ``ICV_INIT`` names: the tests give it JAX's
initial ICV (``jax.random.normal(PRNGKey(0))``, which the port's
generator does not draw), so that an artifact can be held to
``train.py``'s.  It imports no JAX.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def patch_icv_init(train_module, init) -> None:
    """``train_module.GlobalICVEncoder`` replaced by one whose ``icv``
    starts at ``init``."""
    import torch

    base = train_module.GlobalICVEncoder

    class FromInit(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            with torch.no_grad():
                self.icv.copy_(torch.as_tensor(init, dtype=self.icv.dtype))

    train_module.GlobalICVEncoder = FromInit


if __name__ == "__main__":
    import numpy as np

    from licv_vqa_tpu_torch.cli import train

    patch_icv_init(train, np.load(os.environ["ICV_INIT"]))
    train.main(sys.argv[1:])
