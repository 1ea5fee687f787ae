from . import (  # noqa: F401  (MODEL registrations)
    apinet,
    baseline,
    bcnn,
    cbcnn,
    cin,
    crossx,
    interp_parts,
    mpn,
    osme,
    peer_learning,
)
