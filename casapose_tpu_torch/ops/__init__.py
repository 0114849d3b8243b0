"""Kernels, their wrappers and plain versions, and the operations around them.

Importing this package registers the custom operators that an exported
serving program (core/export.py) calls: ``casapose::voting_accumulate``
(ops/voting.py), ``casapose::connected_components``
(ops/connected_components.py) and ``casapose::solve_pnp`` (pose/epnp.py).
"""

from casapose_tpu_torch.ops import voting  # noqa: F401
from casapose_tpu_torch.pose import epnp  # noqa: F401
