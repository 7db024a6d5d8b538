"""Train with the det datasets left out of the evaluation during training
(PyTorch counterpart of the root ``tools/train_without_det_eval.py``): the
flags of ``rscotr_tpu_torch.tools.train``, and
``apis.train_model_without_det_eval`` in place of ``train_model``.

    python -m rscotr_tpu_torch.tools.train_without_det_eval CONFIG ...

``--launcher pytorch`` runs it on every rank of a ``torch.distributed.run``
launch, as for ``tools/train.py``.
"""

from __future__ import annotations

from typing import Sequence

from rscotr_tpu_torch.tools import train as train_cli


def main(argv=None, hooks: Sequence = ()):
    from rscotr_tpu_torch.apis import train_model_without_det_eval
    return train_cli.main(argv, hooks=hooks,
                          train_fn=train_model_without_det_eval)


if __name__ == "__main__":
    main()
    from rscotr_tpu_torch.parallel.mesh import destroy_distributed
    destroy_distributed()
