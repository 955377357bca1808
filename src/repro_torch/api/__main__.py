"""`python -m repro_torch.api`: run a named study from the registry.

    PYTHONPATH=src python -m repro_torch.api --study edp_array_size \
        --smoke --device cpu --csv STUDY_edp_array_size.csv

A thin delegate to `repro_torch.api.study._main`.
"""
import sys

from .study import _main

sys.exit(_main())
