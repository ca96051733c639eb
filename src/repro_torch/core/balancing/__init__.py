"""Dynamic load balancing callbacks (paper §2.4).

A balancer is a callable invoked by the pipeline once per *main iteration*:

    assignments, again = balancer(proxy, comm, iteration)

``assignments[rank]`` maps local proxy bids to target ranks; the framework
then migrates the proxy blocks (:func:`repro.core.proxy.migrate_proxy_blocks`)
and re-invokes the balancer while ``again`` is True — enabling iterative,
diffusion-based schemes (paper Fig. 4).
"""

from .base import Balancer
from .sfc import SFCBalancer
from .diffusion import DiffusionBalancer

__all__ = ["Balancer", "SFCBalancer", "DiffusionBalancer"]
