"""rscotr_tpu_torch: the PyTorch / CUDA port of rscotr_tpu for NVIDIA Hopper.

Module paths mirror ``rscotr_tpu/``. The port imports ``torch`` and never
``jax``, and nothing of the JAX package: it reads the config files under
``configs/`` with its own loader (``utils/config.py``). It builds
(``models.build_model``) the MTL, DINO and RSCoTrSeg models of those
configs, serves (``engine.make_infer_steps``) and trains
(``engine.make_train_step``) their cls, det and seg tasks, co-trains them
(``tools.train``: ``apis.train_model``, ``engine.runner``,
``engine.hooks``, the ``MultiDataLoader`` and iteration strategies of
``data``), and evaluates a checkpoint (``tools.test``:
``engine.checkpoint``, ``data``, ``engine.test``, ``evaluation``). On CUDA
tensors the multi-scale deformable attention core and the Swin window
attention core, forward and backward, launch the hand-written kernels in
``csrc/`` (built with nvcc at first use); on CPU tensors they run their
plain PyTorch versions.
"""
