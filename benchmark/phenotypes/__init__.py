"""Phenotype models, one file a family (``<family>.py``, the name the
configuration's ``family`` gives): ``LINKS``, the links it draws, and
``draw(eta, rng, phenotype)``, the (n,) float64 phenotypes of the linear
predictor ``eta`` from the numpy generator ``rng`` and the configuration's
``phenotype`` group."""
