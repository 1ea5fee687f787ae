from . import baseline, bcnn, cbcnn, mpn, peer_learning  # noqa: F401  (MODEL registrations)
