"""NetworkIndex: port/bandwidth accounting and network offers.

Reference: nomad/structs/network.go:35 (NetworkIndex), :72 (SetNode),
:94 (AddAllocs), :172 (AssignNetwork), :245/:288 (dynamic port pickers).
"""

from __future__ import annotations

import ipaddress
import random
from typing import Dict, List, Optional

from . import consts
from .alloc import Allocation
from .bitmap import Bitmap
from .node import Node
from .resources import NetworkResource, Port


class NetworkIndex:
    def __init__(self):
        self.avail_networks: List[NetworkResource] = []
        self.avail_bandwidth: Dict[str, int] = {}  # by device
        self.used_ports: Dict[str, Bitmap] = {}  # by IP
        self.used_bandwidth: Dict[str, int] = {}  # by device

    def overcommitted(self) -> bool:
        return any(
            used > self.avail_bandwidth.get(device, 0)
            for device, used in self.used_bandwidth.items()
        )

    def set_node(self, node: Node) -> bool:
        """Register the node's available networks and reserved usage.
        Returns True on a port collision."""
        collide = False
        if node.resources:
            for n in node.resources.networks:
                if n.device:
                    self.avail_networks.append(n)
                    self.avail_bandwidth[n.device] = n.mbits
        if node.reserved:
            for n in node.reserved.networks:
                if self.add_reserved(n):
                    collide = True
        return collide

    def add_allocs(self, allocs: List[Allocation]) -> bool:
        collide = False
        for alloc in allocs:
            for task_res in alloc.task_resources.values():
                if not task_res.networks:
                    continue
                if self.add_reserved(task_res.networks[0]):
                    collide = True
        return collide

    def add_reserved(self, n: NetworkResource) -> bool:
        collide = False
        used = self.used_ports.get(n.ip)
        if used is None:
            used = Bitmap(consts.MAX_VALID_PORT)
            self.used_ports[n.ip] = used
        for port in list(n.reserved_ports) + list(n.dynamic_ports):
            if port.value < 0 or port.value >= consts.MAX_VALID_PORT:
                # Early return leaves the index partially applied —
                # reference parity (network.go:129-130 does the same).
                return True
            if used.check(port.value):
                collide = True
            else:
                used.set(port.value)
        self.used_bandwidth[n.device] = self.used_bandwidth.get(n.device, 0) + n.mbits
        return collide

    def _yield_ips(self):
        for n in self.avail_networks:
            try:
                network = ipaddress.ip_network(n.cidr, strict=False)
            except ValueError:
                continue
            for ip in network:
                yield n, str(ip)

    def assign_network(
        self, ask: NetworkResource, rng: Optional[random.Random] = None
    ) -> tuple:
        """Build a network offer for the ask: (offer | None, error string)."""
        rng = rng or random
        err = "no networks available"
        for n, ip_str in self._yield_ips():
            avail = self.avail_bandwidth.get(n.device, 0)
            used_bw = self.used_bandwidth.get(n.device, 0)
            if used_bw + ask.mbits > avail:
                err = "bandwidth exceeded"
                continue

            used = self.used_ports.get(ip_str)
            collision = False
            for port in ask.reserved_ports:
                if port.value < 0 or port.value >= consts.MAX_VALID_PORT:
                    return None, f"invalid port {port.value} (out of range)"
                if used is not None and used.check(port.value):
                    collision = True
                    break
            if collision:
                err = "reserved port collision"
                continue

            dyn_ports, dyn_err = _pick_dynamic_ports_stochastic(used, ask, rng)
            if dyn_err:
                dyn_ports, dyn_err = _pick_dynamic_ports_precise(used, ask, rng)
                if dyn_err:
                    err = dyn_err
                    continue

            offer = NetworkResource(
                device=n.device,
                ip=ip_str,
                mbits=ask.mbits,
                reserved_ports=[Port(p.label, p.value) for p in ask.reserved_ports],
                dynamic_ports=[
                    Port(p.label, v) for p, v in zip(ask.dynamic_ports, dyn_ports)
                ],
            )
            return offer, ""
        return None, err


def _pick_dynamic_ports_stochastic(
    used: Optional[Bitmap], ask: NetworkResource, rng
) -> tuple:
    """Random probing for dynamic ports; fast path, may give up."""
    taken = [p.value for p in ask.reserved_ports]
    picked: List[int] = []
    for _ in ask.dynamic_ports:
        for attempt in range(consts.MAX_RAND_PORT_ATTEMPTS + 1):
            if attempt == consts.MAX_RAND_PORT_ATTEMPTS:
                return [], "stochastic dynamic port selection failed"
            port = rng.randrange(consts.MIN_DYNAMIC_PORT, consts.MAX_DYNAMIC_PORT)
            if used is not None and used.check(port):
                continue
            if port in taken or port in picked:
                continue
            picked.append(port)
            break
    return picked, ""


def _pick_dynamic_ports_precise(
    used: Optional[Bitmap], ask: NetworkResource, rng
) -> tuple:
    """Exhaustive scan of the dynamic range; authoritative failure."""
    used_set = used.copy() if used is not None else Bitmap(consts.MAX_VALID_PORT)
    for port in ask.reserved_ports:
        used_set.set(port.value)
    available = used_set.indexes_in_range(
        False, consts.MIN_DYNAMIC_PORT, consts.MAX_DYNAMIC_PORT
    )
    num = len(ask.dynamic_ports)
    if len(available) < num:
        return [], "dynamic port selection failed"
    rng.shuffle(available)
    return available[:num], ""
