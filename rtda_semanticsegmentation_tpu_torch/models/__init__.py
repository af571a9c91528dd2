"""Eval-form models of the port (BiSeNet-R18)."""
