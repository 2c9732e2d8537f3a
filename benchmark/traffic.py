"""The one traffic generator: a configuration file and a traffic file ->
the plain cluster description that both the program and the reference
are given.

Every seed gets the same sizes: the same nodes, the same number of
nodes in each zone, the same multiset of bound pods a node, the same
backlog. The seed draws only which node gets which zone and which
bound load, independently for each initial state.

A traffic file lists the backlog as groups of pods, queued FIFO in the
order listed. A group is one template: its pods differ only by name.
"copies" repeats a group, each copy with "{i}" in its name and label
values replaced by the copy's index; "controller" gives each copy a
ReplicationController selecting its labels. A key that the generator
does not read is refused, in the configuration and in the traffic file.

The description holds only plain data (strings, numbers, dicts):

    {"namespace": str,
     "states": [{"nodes": [{"name", "allocatable", "labels"}],
                 "bound": [{"name", "node", "labels", "containers"}]}],
     "groups": [{"name", "count", "labels", "containers"}],
     "services": [{"name", "selector"}],
     "controllers": [{"name", "selector", "replicas"}]}
"""

from __future__ import annotations

import copy

import numpy as np

#: the provider whose decisions the reference re-derives
PROVIDER = "DefaultProvider"

CONFIG_KEYS = {"name", "source", "deployment", "reduced", "nodes", "node",
               "zone_label", "zones", "namespace", "services", "provider",
               "guarantees", "assumed"}
NODE_KEYS = {"allocatable"}
ASSUMED_KEYS = {"zone_assignment", "bound_load"}
LOAD_KEYS = {"why", "pods_per_node", "prefix", "labels", "containers"}
TRAFFIC_KEYS = {"why", "states", "groups"}
GROUP_KEYS = {"name", "copies", "pods", "pods_per_node", "labels",
              "containers", "controller"}


def _known(what: str, d: dict, keys: set) -> None:
    unknown = set(d) - keys
    if unknown:
        raise ValueError(f"{what} keys the benchmark does not read: "
                         f"{sorted(unknown)}")


def validate(config: dict, traffic: dict) -> None:
    """Refuse a configuration or traffic file that sets anything the
    generator, the program's set-up or the reference would not read."""
    _known("configuration", config, CONFIG_KEYS)
    _known("configuration node", config["node"], NODE_KEYS)
    _known("configuration assumed", config["assumed"], ASSUMED_KEYS)
    _known("configuration bound_load", config["assumed"]["bound_load"],
           LOAD_KEYS)
    if config["provider"] != PROVIDER:
        raise ValueError(f"provider {config['provider']!r}: the reference "
                         f"implements {PROVIDER} only")
    _known("traffic", traffic, TRAFFIC_KEYS)
    for g in traffic["groups"]:
        _known("traffic group", g, GROUP_KEYS)
        if ("pods" in g) == ("pods_per_node" in g):
            raise ValueError(f"group {g['name']!r} needs one of pods and "
                             f"pods_per_node")


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """A generator for one stream of a seed; any whole number is a seed."""
    return np.random.default_rng([int(seed) % 2**64, stream])


def balanced(values, n: int, rng: np.random.Generator) -> list:
    """n values, each of `values` as often as the others (to within one),
    in an order the generator draws."""
    out = [values[i % len(values)] for i in range(n)]
    return [out[i] for i in rng.permutation(n)]


def groups_of(traffic: dict, nodes: int) -> tuple:
    """The backlog's groups, copies expanded, and their controllers.
    -> ([{"name", "count", "labels", "containers"}], [controller])."""
    groups, controllers = [], []
    for g in traffic["groups"]:
        count = int(g["pods"]) if "pods" in g \
            else int(g["pods_per_node"]) * nodes
        for i in range(int(g.get("copies", 1))):
            name = g["name"].format(i=i)
            labels = {k: v.format(i=i) for k, v in g["labels"].items()}
            groups.append({"name": name, "count": count, "labels": labels,
                           "containers": copy.deepcopy(g["containers"])})
            if g.get("controller"):
                controllers.append({"name": name, "selector": dict(labels),
                                    "replicas": count})
    return groups, controllers


def describe(config: dict, traffic: dict, seed: int) -> dict:
    """The cluster description of one cell for one seed."""
    validate(config, traffic)
    n = int(config["nodes"])
    width = len(str(n - 1))
    names = [f"node-{i:0{width}d}" for i in range(n)]
    load = config["assumed"]["bound_load"]
    states = []
    for s in range(int(traffic["states"])):
        rng = rng_of(seed, s)
        zones = balanced(config["zones"], n, rng)
        per_node = balanced(load["pods_per_node"], n, rng)
        nodes, bound = [], []
        for name, zone, k in zip(names, zones, per_node):
            nodes.append({"name": name,
                          "allocatable": dict(config["node"]["allocatable"]),
                          "labels": {config["zone_label"]: zone}})
            for j in range(k):
                bound.append({"name": f"{load['prefix']}-{name}-{j}",
                              "node": name,
                              "labels": dict(load["labels"]),
                              "containers": copy.deepcopy(
                                  load["containers"])})
        states.append({"nodes": nodes, "bound": bound})
    groups, controllers = groups_of(traffic, n)
    return {"namespace": config["namespace"], "states": states,
            "groups": groups,
            "services": copy.deepcopy(config["services"]),
            "controllers": controllers}


def backlog_size(desc: dict) -> int:
    """Pods a call schedules."""
    return sum(g["count"] for g in desc["groups"])
