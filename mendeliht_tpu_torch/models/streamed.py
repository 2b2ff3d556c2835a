"""Out-of-core (streamed) fit and cv entries, under the names of the JAX
package's ``models/streamed.py``.

The JAX package's resident solver is one traced ``lax.while_loop``, so an
operator that streams host blocks needs its own host-stepped loop there.
The port's solver is stepped from the host already (``univariate.py``),
so a ``StreamedPackedOp`` runs the resident entries themselves, and
these names are those entries: ``fit_iht`` and ``cv_iht`` route a
``HostStreamedGenotypes`` to them.  Their ``checkpoint_dir`` /
``checkpoint_every`` (and the cv's ``progress``, the JAX package's
``show_progress``) are ``univariate.run_segmented``'s; the per-iteration
lines go to ``cfg.log_io``, which ``fit_iht(io=...)`` sets, where the
JAX package's streamed fit takes ``io``.
"""

from .fit import fit_fused_sparse as fit_fused_sparse_host  # noqa: F401
from .univariate import cv_fused as cv_fused_host  # noqa: F401
