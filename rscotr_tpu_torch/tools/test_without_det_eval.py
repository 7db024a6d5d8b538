"""Alias of ``rscotr_tpu_torch.tools.test`` (the counterpart of the root
``tools/test_without_det_eval.py``; the reference ships a byte-identical
duplicate of its test tool)::

    python -m rscotr_tpu_torch.tools.test_without_det_eval CONFIG CKPT ...
"""

from rscotr_tpu_torch.tools.test import main

__all__ = ["main"]

if __name__ == "__main__":
    main()
    from rscotr_tpu_torch.parallel.mesh import destroy_distributed
    destroy_distributed()
