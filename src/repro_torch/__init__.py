"""PyTorch/CUDA port of the HyTGraph reproduction (``repro``).

The layout mirrors ``repro`` (``graph/``, ``core/``, ``kernels/<name>/``,
``stream/``, ``autotune/``, ``models/``, ``train/``, ``data/``,
``launch/``) with the same public names.  The package imports torch, numpy and the standard library only;
the entry points (``to_device_csr``, ``build_runtime``, ``run_hytm``,
``init_state``, ``stream.DeltaCSR``, ``train.train_step.init_train_state``)
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
