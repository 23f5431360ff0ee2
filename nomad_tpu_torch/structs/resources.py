"""Resource types: Port, NetworkResource, Resources.

Reference: nomad/structs/structs.go:765 (Resources), :917 (NetworkResource),
:924 (Port).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Port:
    label: str = ""
    value: int = 0


@dataclass
class NetworkResource:
    device: str = ""  # interface name
    cidr: str = ""  # CIDR block of the interface
    ip: str = ""  # host IP
    mbits: int = 0  # throughput
    reserved_ports: List[Port] = field(default_factory=list)
    dynamic_ports: List[Port] = field(default_factory=list)

    def copy(self) -> "NetworkResource":
        # Field-wise: Ports are two-field value objects, and this copy
        # runs once per task per upserted alloc (plan-apply hot path).
        return NetworkResource(
            device=self.device, cidr=self.cidr, ip=self.ip,
            mbits=self.mbits,
            reserved_ports=[Port(p.label, p.value)
                            for p in self.reserved_ports],
            dynamic_ports=[Port(p.label, p.value)
                           for p in self.dynamic_ports],
        )

    def add(self, delta: "NetworkResource") -> None:
        self.mbits += delta.mbits
        self.reserved_ports.extend(copy.deepcopy(delta.reserved_ports))

    def port_labels(self) -> dict:
        labels = {}
        for p in self.reserved_ports + self.dynamic_ports:
            labels[p.label] = p.value
        return labels


@dataclass
class Resources:
    cpu: int = 0  # MHz
    memory_mb: int = 0
    disk_mb: int = 0
    iops: int = 0
    networks: List[NetworkResource] = field(default_factory=list)

    DEFAULT_CPU = 100
    DEFAULT_MEMORY_MB = 10
    DEFAULT_DISK_MB = 300
    DEFAULT_IOPS = 0

    def copy(self) -> "Resources":
        new = Resources.__new__(Resources)
        new.__dict__.update(self.__dict__)
        new.networks = [n.copy() for n in self.networks]
        return new

    def canonicalize(self) -> None:
        if self.cpu == 0:
            self.cpu = self.DEFAULT_CPU
        if self.memory_mb == 0:
            self.memory_mb = self.DEFAULT_MEMORY_MB
        if self.disk_mb == 0:
            self.disk_mb = self.DEFAULT_DISK_MB

    def merge(self, other: "Resources") -> None:
        """Overlay non-zero fields of other (structs.go Resources.Merge)."""
        if other.cpu:
            self.cpu = other.cpu
        if other.memory_mb:
            self.memory_mb = other.memory_mb
        if other.disk_mb:
            self.disk_mb = other.disk_mb
        if other.iops:
            self.iops = other.iops
        if other.networks:
            self.networks = [n.copy() for n in other.networks]

    def add(self, delta: Optional["Resources"]) -> None:
        """Accumulate delta into self; networks are summed by index
        (structs.go Resources.Add)."""
        if delta is None:
            return
        self.cpu += delta.cpu
        self.memory_mb += delta.memory_mb
        self.disk_mb += delta.disk_mb
        self.iops += delta.iops
        for idx, net in enumerate(delta.networks):
            if idx < len(self.networks):
                self.networks[idx].add(net)
            else:
                self.networks.append(net.copy())

    def superset(self, other: "Resources") -> Tuple[bool, str]:
        """Whether self >= other on every scalar dimension; returns the
        first exhausted dimension name (structs.go Resources.Superset —
        network is checked separately via NetworkIndex)."""
        if self.cpu < other.cpu:
            return False, "cpu"
        if self.memory_mb < other.memory_mb:
            return False, "memory"
        if self.disk_mb < other.disk_mb:
            return False, "disk"
        if self.iops < other.iops:
            return False, "iops"
        return True, ""

    def net_index(self, n: NetworkResource) -> int:
        """Index of a network resource matching n's device, else -1."""
        for i, net in enumerate(self.networks):
            if net.device == n.device:
                return i
        return -1
