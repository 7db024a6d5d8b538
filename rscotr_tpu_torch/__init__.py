"""rscotr_tpu_torch: the PyTorch / CUDA port of rscotr_tpu for NVIDIA Hopper.

Module paths mirror ``rscotr_tpu/``. The port imports ``torch`` and never
``jax``, and nothing of the JAX package: it reads the config files under
``configs/`` with its own loader (``utils/config.py``). It builds
(``models.build_model``) the MTL, DINO and RSCoTrSeg models of those
configs, and serves (``engine.make_infer_steps``) and trains
(``engine.make_train_step``) their cls, det and seg tasks. On CUDA
tensors the multi-scale deformable attention core and the Swin window
attention core, forward and backward, launch the hand-written kernels in
``csrc/`` (built with nvcc at first use); on CPU tensors they run their
plain PyTorch versions.
"""
