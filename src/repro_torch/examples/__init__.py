"""Example drivers of the port, the counterparts of ``examples/*.py``.

Each is a module with ``main(argv=None)`` and a ``--device`` flag (default
``cuda``; raises without a card, ``--device cpu`` runs the plain PyTorch
path):

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.async_drl_train --fast
    PYTHONPATH=src python -m repro_torch.examples.lm_train --olaf
    PYTHONPATH=src python -m repro_torch.examples.serve_decode
"""
