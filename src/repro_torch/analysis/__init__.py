"""Analysis (counterpart of ``repro.analysis``): roofline terms on H100s
and the analytic step counts; the dry run that fills them is
``launch/dryrun.py``."""

from repro_torch.analysis.roofline import (Roofline, decode_round_alpha,
                                           kernel_call_cost,
                                           kernel_hbm_bytes, model_flops,
                                           roofline_terms)

__all__ = ["Roofline", "decode_round_alpha", "kernel_call_cost",
           "kernel_hbm_bytes", "model_flops", "roofline_terms"]
