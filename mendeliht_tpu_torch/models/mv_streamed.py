"""Out-of-core (streamed) multivariate fit and cv entries, under the names
of the JAX package's ``models/mv_streamed.py``: the port's host-stepped
mv solver (``mv.run_mv_segment`` through ``univariate.run_segmented``)
runs a ``StreamedPackedOp`` as it is, as ``models/streamed.py`` says of
the univariate one."""

from .mv import cv_mv as cv_mv_host, fit_mv as fit_mv_host  # noqa: F401
