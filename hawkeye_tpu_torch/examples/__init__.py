"""The port's Example trainers: counterparts of the JAX package's
``Examples/*.py``, one module of the same name each, run as

    python -m hawkeye_tpu_torch.examples.<Name> --config configs/<X>.yaml [--device cpu]

on the CUDA device unless ``--device cpu`` is given. Ported so far:
Baseline, BCNN, CBCNN, MPN, PairConfusion, PeerLearning, OSMENet, APINet,
CIN, CrossX, InterpPartsNet, ProtoTreeNet and DCL.
"""

