"""repro.core — the paper's contribution: ACADL + AIDG + accelerator zoo + mapping."""
