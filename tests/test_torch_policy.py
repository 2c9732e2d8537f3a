"""Policy files and the provider registry in the port against the JAX
package, on the CPU: resolve_policy_tpu gives the same device config on
every argument form (and declines the same host-only documents), the
registries hold the same keys, and the port's create_from_config /
create_from_provider (the counterparts of ConfigFactory's two resolution
paths) send a Policy to the device or to the host oracle as the JAX
factory does, with the oracle's decisions."""

import dataclasses
import json

import pytest
import torch

from kubernetes_tpu.scheduler import algorithmprovider as JAP
from kubernetes_tpu.scheduler import plugins as JPlug
from kubernetes_tpu.scheduler import policy as JPol
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm

from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.oracle import GenericScheduler as PortOracle
from kubernetes_tpu_torch.scheduler import algorithmprovider as TAP
from kubernetes_tpu_torch.scheduler import factory as TF
from kubernetes_tpu_torch.scheduler import plugins as TPlug
from kubernetes_tpu_torch.scheduler import policy as TPol
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.scheduler.core import ExtendedGenericScheduler
from kubernetes_tpu_torch.scheduler.extender import HTTPExtender

import tests.test_policy_tpu as TPT
from tests.test_torch_ops import to_port

POLICY = TPT.POLICY
NO_RESOURCES = {"kind": "Policy",
                "predicates": [{"name": "PodToleratesNodeTaints"}],
                "priorities": [{"name": "EqualPriority", "weight": 1}]}
CUSTOM = {"kind": "Policy", "predicates": [{"name": "SomeCustomPredicate"}],
          "priorities": []}
WITH_EXTENDER = dict(POLICY, extenders=[{"urlPrefix": "http://x",
                                         "filterVerb": "f", "weight": 1}])
#: every argument form, legacy aliases and every device-expressible key
ALL_FORMS = {"kind": "Policy", "predicates": [
    {"name": n} for n in sorted(TPol._DEVICE_PREDICATES)] + [
    {"name": "Affinity", "argument": {"serviceAffinity": {
        "labels": ["zone", "rack"]}}},
    {"name": "NoSSD", "argument": {"labelsPresence": {
        "labels": ["disktype"], "presence": False}}}],
    "priorities": [{"name": n, "weight": i + 1} for i, n in enumerate(
        sorted(TPol._DEVICE_PRIORITIES))] + [
    {"name": "Spread", "weight": 3, "argument": {"serviceAntiAffinity": {
        "label": "rack"}}},
    {"name": "NotDDR", "weight": 2, "argument": {"labelPreference": {
        "label": "memtype", "presence": False}}}]}

DOCUMENTS = {"policy": POLICY, "all forms": ALL_FORMS,
             "no resource predicate": NO_RESOURCES, "custom": CUSTOM,
             "extender": WITH_EXTENDER,
             "escape hatch": dict(POLICY, provider="DefaultProvider")}


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_resolve_policy_tpu_matches_jax(name):
    """Tuple for tuple, including the host-only None cases."""
    doc = json.dumps(DOCUMENTS[name])
    for weight in (1, 3):
        want = JPol.resolve_policy_tpu(JPol.load_policy(doc), weight)
        got = TPol.resolve_policy_tpu(TPol.load_policy(doc), weight)
        if want is None:
            assert got is None
        else:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert got.hard_pod_affinity_weight == weight
    if name in ("no resource predicate", "custom", "extender"):
        assert got is None


def test_load_policy_reads_a_file(tmp_path):
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(WITH_EXTENDER))
    got = TPol.load_policy(str(path))
    want = JPol.load_policy(str(path))
    assert repr(got) == repr(want)
    assert got.extenders[0].url_prefix == "http://x"
    with pytest.raises(TPol.PolicyValidationError):
        TPol.load_policy(json.dumps({"priorities": [
            {"name": "LeastRequestedPriority", "weight": 0}]}))


@pytest.mark.parametrize("provider", ["DefaultProvider", "TPUProvider",
                                      "CUDAProvider"])
def test_registry_keys_match_jax(provider):
    """The port registers the JAX package's keys; CUDAProvider is the
    device provider under the port's own name (JAX's TPUProvider)."""
    got = TPlug.get_algorithm_provider(provider)
    want = JPlug.get_algorithm_provider(
        JAP.TPU_PROVIDER_NAME if provider == TAP.CUDA_PROVIDER_NAME
        else provider)
    assert got.fit_predicate_keys == want.fit_predicate_keys
    assert got.priority_keys == want.priority_keys
    assert (got.algorithm_factory is None) == (want.algorithm_factory is None)
    # resolve_policy registers a Policy's custom argument forms, so only
    # the built-in predicate keys are compared
    assert set(TAP.CANONICAL_PREDICATE_ORDER) <= \
        TPlug.registered_predicate_names()
    assert TAP.CANONICAL_PREDICATE_ORDER == JAP.CANONICAL_PREDICATE_ORDER
    assert TPlug.registered_priority_names() == \
        JPlug.registered_priority_names()


def _schedule(algo, pods, nodes):
    return algo.schedule_backlog(pods, PortState.build(nodes))


def test_policy_file_schedules_through_the_device(tmp_path):
    """The test_policy_tpu document, loaded from a file: the device
    algorithm (on the CPU here), decisions equal to the host oracle
    resolved from the same policy and to the JAX package's algorithm."""
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(POLICY))
    algo = TF.create_from_config(TPol.load_policy(str(path)), device="cpu")
    assert isinstance(algo, TorchScheduleAlgorithm)
    nodes, pods = to_port(TPT._nodes()), to_port(TPT._pods())
    got = _schedule(algo, pods, nodes)
    assert all(got) and "n6" not in got  # LabelsPresence excludes n6
    policy = TPol.load_policy(json.dumps(POLICY))
    preds, prios = TPol.resolve_policy(policy, TPlug.PluginFactoryArgs())
    oracle = PortOracle(predicates=list(preds.items()), priorities=prios)
    assert got == _schedule(oracle, pods, nodes)
    jcfg = JPol.resolve_policy_tpu(JPol.load_policy(json.dumps(POLICY)))
    assert got == TPUScheduleAlgorithm(config=jcfg).schedule_backlog(
        TPT._pods(), TPT.ClusterState.build(TPT._nodes()))


@pytest.mark.parametrize("name", ["escape hatch", "no resource predicate"])
def test_host_only_policies_take_the_host_path(name):
    algo = TF.create_from_config(
        TPol.load_policy(json.dumps(DOCUMENTS[name])), device="cpu")
    # the JAX factory's host path: ExtendedGenericScheduler, here with no
    # extenders
    assert type(algo) is ExtendedGenericScheduler and algo.extenders == []
    nodes, pods = to_port(TPT._nodes()), to_port(TPT._pods(8))
    policy = TPol.load_policy(json.dumps(DOCUMENTS[name]))
    preds, prios = TPol.resolve_policy(policy, TPlug.PluginFactoryArgs())
    assert [n for n, _ in algo.predicates] == list(preds)
    want = PortOracle(predicates=list(preds.items()), priorities=prios)
    assert _schedule(algo, pods, nodes) == _schedule(want, pods, nodes)


def test_extender_policy_names_the_daemon_slice():
    """The daemon slice brought the outbound extender: a Policy with
    extenders takes the host path with one HTTPExtender per entry
    (tests/test_torch_daemon.py drives one against a local extender)."""
    algo = TF.create_from_config(
        TPol.load_policy(json.dumps(WITH_EXTENDER)), device="cpu")
    assert type(algo) is ExtendedGenericScheduler
    assert [(e.config.url_prefix, e.config.filter_verb, e.weight)
            for e in algo.extenders] == [("http://x", "f", 1)]
    assert all(type(e) is HTTPExtender for e in algo.extenders)


@pytest.mark.parametrize("provider", ["TPUProvider", "CUDAProvider",
                                      "DefaultProvider"])
def test_create_from_provider(provider):
    """A provider-only Policy resolves through create_from_provider: the
    device providers give the batched algorithm, DefaultProvider the host
    scheduler with its keys; all agree with the default oracle."""
    algo = TF.create_from_config(
        TPol.load_policy(json.dumps({"provider": provider})), device="cpu")
    if provider == "DefaultProvider":
        assert type(algo) is PortOracle
        assert {n for n, _ in algo.predicates} == \
            TPlug.get_algorithm_provider(provider).fit_predicate_keys
    else:
        assert isinstance(algo, TorchScheduleAlgorithm)
        assert algo._wave.device == torch.device("cpu")
    nodes, pods = to_port(TPT._nodes()), to_port(TPT._pods(12))
    assert _schedule(algo, pods, nodes) == _schedule(PortOracle(), pods,
                                                     nodes)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA the default device raises; nothing carries on on the
    CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.create_from_config(TPol.load_policy(json.dumps(POLICY)))
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.create_from_provider("CUDAProvider")
