"""Static kernel-contract and config-rot checker of the port (the
counterpart of ``repro.analysis``).

``python -m repro_torch.analysis --strict`` drives every shipped config
through the port's served entries and proves the CUDA kernels' address
arithmetic -- see ``repro_torch.analysis.findings.RULES`` for the rule
catalogue (the reference's ids, with the port's meaning) and
``repro_torch.analysis.runner`` for the modes (``plain``, ``meta``,
``cuda``)."""
from repro_torch.analysis.bounds import check_kernel_spec
from repro_torch.analysis.donation import check_aliases, check_donation, storages
from repro_torch.analysis.findings import RULES, Finding, Report
from repro_torch.analysis.mesh_lints import (RecordingMesh, lint_collectives,
                                             param_gather_shapes)
from repro_torch.analysis.op_lints import OpRecorder, check_logits_dtype, lint_ops
from repro_torch.analysis.runner import (MODES, QUANTS, analysis_config, check_cell,
                                         check_kernels, check_paging, check_resilience,
                                         check_sharded, run_analysis)

__all__ = [
    "RULES", "Finding", "Report",
    "check_kernel_spec", "check_donation", "check_aliases", "storages",
    "check_logits_dtype", "OpRecorder", "lint_ops",
    "RecordingMesh", "lint_collectives", "param_gather_shapes",
    "MODES", "QUANTS", "analysis_config", "check_cell", "check_kernels",
    "check_paging", "check_resilience", "check_sharded", "run_analysis",
]
