"""Command-line entry points of the port, run as ``python -m
synergynet_tpu_torch.cli.<name>``: ``train`` (the reference's
``main_train.py``), ``evaluate`` (``benchmark.py``), ``infer``
(``singleImage.py``), ``artistic`` (``artistic.py``) and ``uv_texture``
(``uv_texture_realFaces.py``). Each runs on the card unless
``--platform cpu`` asks for the CPU."""
