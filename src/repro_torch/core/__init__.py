"""OLAF core: opportunistic in-network aggregation for async DRL.

The counterpart of ``repro.core``: the paper's contribution as composable
modules, host-side numpy copies beside the torch queue.
  - aggregation: update semantics (aggregate / replace / reward gating)
  - olaf_queue:  the OlafQueue (python reference + the torch queue state)
  - aom:         Age-of-Model staleness metric
  - txctl:       worker-side transmission control from reverse-path feedback
  - netsim:      discrete-event network simulator (ns-3 analogue)
  - verifier:    Z3 formal verification of AoM objectives

``repro``'s ``jax_*`` queue functions are ``queue_init``, ``enqueue_one``,
``enqueue_batch``, ``enqueue_burst``, ``dequeue_one`` and ``dequeue_burst``
here; its ``*_donating`` variants have no counterpart (PyTorch has no
buffer donation, H5).
"""
from repro_torch.core.aggregation import Action, Update, aggregate, gate, replace
from repro_torch.core.aom import (aom_trajectory, average_aom, jain_fairness,
                                  peak_aom, per_cluster_average_aom)
from repro_torch.core.olaf_queue import (PyFifoQueue, PyOlafQueue,
                                         TorchQueueState, dequeue_burst,
                                         dequeue_one, enqueue_batch,
                                         enqueue_burst, enqueue_one,
                                         queue_init)
from repro_torch.core.txctl import (QueueFeedback, TransmissionController,
                                    TxControlConfig)

__all__ = [
    "Action", "Update", "aggregate", "gate", "replace",
    "aom_trajectory", "average_aom", "jain_fairness", "peak_aom",
    "per_cluster_average_aom",
    "PyFifoQueue", "PyOlafQueue", "TorchQueueState", "dequeue_burst",
    "dequeue_one", "enqueue_batch", "enqueue_burst", "enqueue_one",
    "queue_init",
    "QueueFeedback", "TransmissionController", "TxControlConfig",
]
