"""Repo-native equivalents of the reference's script tools
(reference src/scripts/, built with -DSCRIPTS=ON): data simulation and
truth-alignment scoring, so benchmark data generation and accuracy checks
do not depend on the reference build tree.

Copy of centrolign_tpu/tools/__init__.py.
"""
