"""hyperkube (cmd/hyperkube) for the port: every component behind one
entry point.

    python -m kubernetes_tpu_torch.hyperkube apiserver --port 0
    python -m kubernetes_tpu_torch.hyperkube scheduler --master http://... \
        --device cuda
    python -m kubernetes_tpu_torch.hyperkube extender --port 8090 --device cpu
    python -m kubernetes_tpu_torch.hyperkube controller-manager --server http://...
    python -m kubernetes_tpu_torch.hyperkube kubelet --server http://... --node n1
    python -m kubernetes_tpu_torch.hyperkube proxy --server http://... --node n1
    python -m kubernetes_tpu_torch.hyperkube federation-apiserver --port 0
    python -m kubernetes_tpu_torch.hyperkube federation-controller-manager \
        --server http://...
    python -m kubernetes_tpu_torch.hyperkube kubefed join east \
        --server http://FED --cluster-endpoint http://...
    python -m kubernetes_tpu_torch.hyperkube local-up --device cuda
                                          # all-in-one cluster
                                          # (hack/local-up-cluster.sh)

PyTorch counterpart of kubernetes_tpu/hyperkube.py, with the same
subcommands and flags. Three take a torch device: `scheduler` and
`local-up` run the port's daemon on --device, the card unless it says
cpu (--master is the apiserver's URL, as --server), and `extender` runs
the port's device program over the scheduler-extender wire protocol.
The others run the port's copies of the host subsystems as the JAX
hyperkube runs them. As there, a non-empty KUBERNETES_TPU_PROFILE arms a
stack sampler over every thread whose tally SIGTERM writes to the file
that variable names; the scheduler reads the same variable as its
profile's name (scheduler/optimizer), so one value does both.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time


def _client(server: str, tls_ca: str = "", insecure: bool = False,
            user: str = "", groups=()):
    from kubernetes_tpu_torch.client.rest import RESTClient
    from kubernetes_tpu_torch.client.transport import HTTPTransport

    return RESTClient(HTTPTransport(server, tls_ca=tls_ca,
                                    insecure=insecure, user=user,
                                    groups=groups))


def _client_from(args, user: str = "", groups=()):
    """Every daemon authenticates with its own system identity so APF
    classification and the audit log see the real caller (the
    reference's per-component kubeconfig users)."""
    return _client(
        args.server,
        tls_ca=getattr(args, "certificate_authority", ""),
        insecure=getattr(args, "insecure_skip_tls_verify", False),
        user=user,
        groups=groups,
    )


def _wait_forever():
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def run_apiserver(args) -> None:
    from kubernetes_tpu_torch.apiserver.server import APIServer

    store = None
    monitor = None
    if getattr(args, "store", "") == "quorum":
        # HA profile: this apiserver embeds ONE member of a 3+ node
        # majority-ack consensus store; any member takes client
        # traffic (followers forward writes / barrier reads)
        from kubernetes_tpu_torch.storage.quorum import NodeConfig, QuorumStore

        if not args.data_dir:
            raise SystemExit("--store=quorum requires --data-dir")
        if not args.quorum_id:
            raise SystemExit("--store=quorum requires --quorum-id")
        peers = {}
        for part in (args.quorum_peers or "").split(","):
            part = part.strip()
            if not part:
                continue
            pid, _, addr = part.partition("=")
            pid = pid.strip()
            if pid == args.quorum_id:
                # operators naturally deploy ONE symmetric member
                # list; a node must not count itself as its own peer
                # (majority math and a self-replicator would break)
                continue
            phost, _, pport = addr.rpartition(":")
            peers[pid] = (phost, int(pport))
        store = QuorumStore(NodeConfig(
            node_id=args.quorum_id,
            data_dir=args.data_dir,
            peers=peers,
            listen_port=args.quorum_listen,
            election_timeout=args.quorum_election_timeout,
        )).start()
        print(f"quorum member {args.quorum_id} peering on "
              f"{store.address[0]}:{store.address[1]} "
              f"({len(peers)} peers)", flush=True)
        if not store.wait_leader(60):
            print("warning: no quorum leader emerged within 60s "
                  "(serving anyway; writes 503 until a majority "
                  "connects)", flush=True)
    elif getattr(args, "standby_of", ""):
        # HA standby: WAL-shipped follower + promotion on primary loss
        from kubernetes_tpu_torch.storage.replicated import (
            FollowerStore,
            PromotionMonitor,
        )

        if not args.data_dir:
            raise SystemExit("--standby-of requires --data-dir")
        rhost, _, rport = args.standby_of.rpartition(":")
        store = FollowerStore(args.data_dir, (rhost, int(rport)))
        if not store.synced(60):
            raise SystemExit("standby never completed its initial sync")
        if args.primary_url:
            probe_client = _client(args.primary_url)
            monitor = PromotionMonitor(
                store, probe=probe_client.healthz,
                on_promote=lambda: print("standby PROMOTED", flush=True),
            ).run()
    elif getattr(args, "replicate_listen", None) is not None:
        from kubernetes_tpu_torch.storage.replicated import ReplicatedStore

        if not args.data_dir:
            raise SystemExit("--replicate-listen requires --data-dir")
        store = ReplicatedStore(
            args.data_dir, repl_port=args.replicate_listen
        )
        print(f"replication listener on "
              f"{store.repl_address[0]}:{store.repl_address[1]}",
              flush=True)
    server = APIServer(
        store=store, data_dir=(None if store else args.data_dir or None),
        admission_control=getattr(args, "admission_control", ""),
    )
    host, port = server.serve_http(
        port=args.port,
        tls_cert=args.tls_cert_file,
        tls_key=args.tls_private_key_file,
        max_in_flight=args.max_requests_inflight,
        enable_binary=args.enable_binary_wire,
    )
    scheme_str = "https" if args.tls_cert_file else "http"
    print(f"kube-apiserver listening on {scheme_str}://{host}:{port}",
          flush=True)
    _wait_forever()


def run_extender(args) -> None:
    """Serve the port's program as a scheduler-extender HTTP service
    (Filter/Prioritize + bulk ScheduleBacklog) for external schedulers."""
    from kubernetes_tpu_torch.scheduler.extender_server import (
        TorchExtenderServer,
    )

    server = TorchExtenderServer(device=args.device)
    host, port = server.serve_http(port=args.port)
    print(
        f"torch-extender serving Filter/Prioritize/ScheduleBacklog on "
        f"http://{host}:{port}/v1beta1 ({server.device})",
        flush=True,
    )
    _wait_forever()


def run_scheduler(args) -> None:
    """Deviation from kubernetes_tpu/hyperkube.py run_scheduler: the
    daemon schedules on --device (the card unless it says cpu), also
    when a --config file sets the other options."""
    from kubernetes_tpu_torch.scheduler.server import (
        SchedulerServer,
        SchedulerServerOptions,
    )

    if args.config:
        # flags-as-API-object: a versioned KubeSchedulerConfiguration
        # file wins over individual flags (componentconfig idiom)
        options = SchedulerServerOptions.from_config_file(args.config)
    else:
        options = SchedulerServerOptions(
            algorithm_provider=args.algorithm_provider
        )
    options.device = args.device
    if getattr(args, "leader_elect", False):
        # scheduler HA (server.go:140-157): two+ scheduler processes
        # share one lease; the holder schedules, standbys take over
        # when the holder dies or releases
        options.leader_elect = True
        options.leader_elect_identity = args.leader_elect_identity
        options.leader_elect_lease_duration = args.lease_duration
        options.leader_elect_renew_deadline = args.renew_deadline
        options.leader_elect_retry_period = args.retry_period
    if getattr(args, "serve_port", None) is not None:
        options.serve_port = args.serve_port
    sched = SchedulerServer(
        _client_from(args, user="system:kube-scheduler"), options
    ).start()
    print("kube-scheduler running"
          + (" (leader-elect)" if options.leader_elect else ""),
          flush=True)
    _wait_forever()
    sched.stop()


def run_controller_manager(args) -> None:
    from kubernetes_tpu_torch.controller.manager import ControllerManager

    mgr = ControllerManager(
        _client_from(args, user="system:kube-controller-manager")
    ).start()
    print("kube-controller-manager running", flush=True)
    _wait_forever()
    mgr.stop()


def run_kubelet(args) -> None:
    from kubernetes_tpu_torch.kubelet import (
        FakeRuntime,
        Kubelet,
        KubeletConfig,
        ProcessRuntime,
    )

    if args.config:
        from kubernetes_tpu_torch.apis.componentconfig import (
            load_component_config,
        )

        kc = load_component_config(args.config, "KubeletConfiguration")
        # the config file is the whole configuration — its values are
        # taken verbatim (a falsy file value must not lose to a flag);
        # only nodeName falls back to --node when the file leaves it ""
        cfg = KubeletConfig(
            node_name=kc.node_name or args.node,
            sync_frequency=kc.sync_frequency_seconds,
            node_status_update_frequency=(
                kc.node_status_update_frequency_seconds
            ),
            serve_api=kc.serve_api,
            api_tls_cert=kc.api_tls_cert,
            api_tls_key=kc.api_tls_key,
            api_auth_token=kc.api_auth_token,
            eviction_memory_threshold=kc.eviction_memory_threshold,
            max_pods=kc.max_pods,
        )
    else:
        cfg = KubeletConfig(
            node_name=args.node,
            serve_api=args.serve_api,
            api_tls_cert=args.tls_cert_file,
            api_tls_key=args.tls_private_key_file,
            api_auth_token=args.auth_token,
        )
    # a standalone kubelet daemon runs REAL processes as containers
    # (docker_manager.go's role); --fake-runtime keeps the hollow seam
    runtime = FakeRuntime() if args.fake_runtime else ProcessRuntime()
    if (cfg.serve_api and not args.fake_runtime
            and not cfg.api_auth_token):
        print(
            "refusing: serving the node API with the process runtime "
            "and no auth token would expose unauthenticated /exec "
            "(remote code execution); set --auth-token or the config's "
            "apiAuthToken (and ideally TLS)",
            file=sys.stderr,
        )
        raise SystemExit(2)
    kl = Kubelet(
        _client_from(args, user=f"system:node:{cfg.node_name}",
                     groups=("system:nodes",)),
        cfg, runtime,
    ).run()
    print(f"kubelet {args.node} running "
          f"({'fake' if args.fake_runtime else 'process'} runtime)",
          flush=True)
    _wait_forever()
    kl.stop()
    if isinstance(runtime, ProcessRuntime):
        runtime.close()


def run_proxy(args) -> None:
    from kubernetes_tpu_torch.proxy import Proxier

    p = Proxier(_client_from(args, user="system:kube-proxy"),
                args.node).run()
    print(f"kube-proxy {args.node} running", flush=True)
    _wait_forever()
    p.stop()


def run_federation_apiserver(args) -> None:
    """federation/cmd/federated-apiserver."""
    from kubernetes_tpu_torch.federation import FederatedAPIServer

    server = FederatedAPIServer()
    host, port = server.serve_http(port=args.port)
    print(f"federation-apiserver on http://{host}:{port}", flush=True)
    _wait_forever()
    server.shutdown_http()


def run_federation_controller_manager(args) -> None:
    """federation/cmd/federation-controller-manager."""
    from kubernetes_tpu_torch.federation import FederationControllerManager

    mgr = FederationControllerManager(_client(args.server)).start()
    print(f"federation-controller-manager against {args.server}", flush=True)
    _wait_forever()
    mgr.stop()


def run_kubefed(args) -> None:
    """federation/cmd/kubefed join/unjoin against the federated API."""
    from kubernetes_tpu_torch.federation import join_cluster, unjoin_cluster

    fed = _client(args.server)
    if args.action == "join":
        if not args.cluster_endpoint:
            raise SystemExit("join requires --cluster-endpoint")
        join_cluster(fed, args.name, args.cluster_endpoint)
        print(f"cluster {args.name!r} joined", flush=True)
    else:
        unjoin_cluster(fed, args.name)
        print(f"cluster {args.name!r} unjoined", flush=True)


def run_local_up(args) -> None:
    """hack/local-up-cluster.sh: a full cluster in one process.

    Deviation from kubernetes_tpu/hyperkube.py run_local_up: the
    scheduler daemon runs on --device (the card unless it says cpu),
    passed as SchedulerServerOptions(device=...), and --algorithm-provider
    defaults to CUDAProvider where the JAX command has TPUProvider. A
    daemon that cannot reach its device raises out of this function, so
    the command exits non-zero rather than serving a cluster with no
    scheduler."""
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.controller.manager import ControllerManager
    from kubernetes_tpu_torch.dns import DNSRecords
    from kubernetes_tpu_torch.kubemark import HollowCluster
    from kubernetes_tpu_torch.scheduler.server import (
        SchedulerServer,
        SchedulerServerOptions,
    )

    server = APIServer(data_dir=args.data_dir or None)
    host, port = server.serve_http(port=args.port)
    # per-component identities (APF classification + audit): the shared
    # admin client covers setup and the hollow kubelets; scheduler and
    # controller-manager authenticate as themselves
    client = _client(f"http://{host}:{port}", user="system:admin",
                     groups=("system:masters",))
    sched_client = _client(f"http://{host}:{port}",
                           user="system:kube-scheduler")
    mgr_client = _client(f"http://{host}:{port}",
                         user="system:kube-controller-manager")
    cluster = HollowCluster(client, args.nodes).run()
    # real nodes: kubelets on the PROCESS runtime — pods scheduled there
    # run as live OS processes (docker_manager.go's role, sandbox form)
    real_kubelets = []
    real_runtimes = []
    if getattr(args, "real_nodes", 0):
        from kubernetes_tpu_torch.kubelet import (
            Kubelet,
            KubeletConfig,
            ProcessRuntime,
        )

        for i in range(args.real_nodes):
            rt = ProcessRuntime()
            real_runtimes.append(rt)
            real_kubelets.append(Kubelet(
                client,
                KubeletConfig(node_name=f"real-node-{i:03d}"),
                rt,
            ).run())
    # the cloud provider behind the controller-manager. "local" (the
    # default): each hollow node gets a live userspace proxy and the
    # provider's LoadBalancer fronts them, so `kubectl expose
    # --type=LoadBalancer` provisions a balancer that forwards bytes.
    # "multizone": the simulated regional cloud (zonal disks, async
    # attach, per-zone LB frontends). "fake"/"": the recorder.
    from kubernetes_tpu_torch.proxy.userspace import UserspaceProxier

    proxiers = []
    if getattr(args, "cloud_provider", "local") == "multizone":
        from kubernetes_tpu_torch.cloudprovider import MultiZoneCloud

        cloud = MultiZoneCloud(attach_latency=0.05, detach_latency=0.05)
        for i in range(args.nodes):
            cloud.add_instance(f"hollow-node-{i:04d}")
    else:
        from kubernetes_tpu_torch.cloudprovider import LocalCloud

        cloud = LocalCloud()
        for i in range(args.nodes):
            node_name = f"hollow-node-{i:04d}"
            proxier = UserspaceProxier(client, node_name=node_name).run()
            proxiers.append(proxier)
            cloud.register_node(node_name, proxier)
    mgr = ControllerManager(mgr_client, cloud=cloud).start()
    sched = SchedulerServer(
        sched_client,
        SchedulerServerOptions(algorithm_provider=args.algorithm_provider,
                               device=args.device),
    ).start()
    # componentstatuses: the in-process analogue of the master probing
    # scheduler/controller-manager health ports
    def _sched_health():
        ok = (sched.scheduler is not None
              and not sched.scheduler.config.stop_everything.is_set())
        return ok, "ok" if ok else "scheduling loop stopped"

    def _mgr_health():
        ok = mgr.is_leader()
        return ok, "ok" if ok else "not the active leader"

    server.register_component("scheduler", _sched_health)
    server.register_component("controller-manager", _mgr_health)
    dns = DNSRecords(client).run()
    from kubernetes_tpu_torch.dns import DNSServer

    dns_srv = DNSServer(dns)
    dns_host, dns_port = dns_srv.serve(port=args.dns_port)
    print(
        f"local cluster up: http://{host}:{port} ({args.nodes} hollow nodes)\n"
        f"kube-dns on {dns_host}:{dns_port}/udp+tcp "
        f"(dig @{dns_host} -p {dns_port} <svc>.<ns>.svc.cluster.local)\n"
        f"try: python -m kubernetes_tpu_torch.kubectl -s http://{host}:{port} get nodes",
        flush=True,
    )
    _wait_forever()
    dns_srv.shutdown()
    dns.stop()
    sched.stop()
    mgr.stop()
    for proxier in proxiers:
        proxier.stop()
    for kl in real_kubelets:
        kl.stop()
    for rt in real_runtimes:
        rt.close()
    cluster.stop()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="hyperkube")
    sub = ap.add_subparsers(dest="component", required=True)

    p = sub.add_parser("apiserver")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument(
        "--data-dir", default="",
        help="persist the store here (WAL + snapshot); restarting with "
        "the same dir recovers all state with RV continuity",
    )
    p.add_argument("--tls-cert-file", default="")
    p.add_argument("--tls-private-key-file", default="")
    p.add_argument(
        "--max-requests-inflight", type=int, default=0,
        help="bound concurrent non-watch requests; excess gets 429 "
        "(0 = unlimited)",
    )
    p.add_argument(
        "--enable-binary-wire", action="store_true",
        help="accept/serve the TLV binary content type (kubemark-style "
        "protobuf analogue; data-only, safe for untrusted callers)",
    )
    p.add_argument(
        "--admission-control", default="",
        help="comma-separated admission plugin chain (e.g. "
        "NamespaceLifecycle,AlwaysPullImages,SecurityContextDeny,"
        "LimitRanger,InitialResources,ResourceQuota)",
    )
    p.add_argument(
        "--store", default="", choices=["", "quorum"],
        help="storage profile: '' = single-node (memory, or durable "
        "with --data-dir); 'quorum' = one member of a 3+ node "
        "majority-ack consensus store (leader election, log "
        "replication, linearizable reads; requires --data-dir, "
        "--quorum-id and --quorum-peers)",
    )
    p.add_argument(
        "--quorum-id", default="",
        help="this member's node id in the quorum (e.g. q0)",
    )
    p.add_argument(
        "--quorum-listen", type=int, default=0, metavar="PORT",
        help="peer-RPC listen port for --store=quorum (0 = ephemeral; "
        "fixed ports let peers find each other across restarts)",
    )
    p.add_argument(
        "--quorum-peers", default="", metavar="ID=HOST:PORT,...",
        help="the OTHER quorum members' peer-RPC addresses, e.g. "
        "q1=127.0.0.1:7001,q2=127.0.0.1:7002",
    )
    p.add_argument(
        "--quorum-election-timeout", type=float, default=1.0,
        metavar="SECONDS",
        help="base raft election timeout (etcd-style 1s default; each "
        "reset re-rolls uniform [T, 2T]). The leader-lease window is "
        "a fraction of this, so smaller = faster failover AND shorter "
        "lease reads between renewals",
    )
    p.add_argument(
        "--replicate-listen", type=int, default=None, metavar="PORT",
        help="serve a WAL-shipping replication listener for a standby "
        "(the etcd-cluster property at primary/standby scale; commits "
        "ack only after the standby has them). Requires --data-dir",
    )
    p.add_argument(
        "--standby-of", default="", metavar="HOST:PORT",
        help="run as the replication STANDBY of the primary's "
        "--replicate-listen address; writes 503 until promoted",
    )
    p.add_argument(
        "--primary-url", default="",
        help="with --standby-of: probe this apiserver URL and "
        "self-promote after sustained liveness failures",
    )

    def add_client_flags(p):
        p.add_argument("--server", "-s", default="http://127.0.0.1:8080")
        p.add_argument(
            "--certificate-authority", default="",
            help="CA file pinning a TLS apiserver (kubeconfig idiom)",
        )
        p.add_argument("--insecure-skip-tls-verify", action="store_true")

    p = sub.add_parser("scheduler")
    add_client_flags(p)
    p.add_argument("--master", dest="server", default=argparse.SUPPRESS,
                   help="the apiserver's URL (the same as --server)")
    p.add_argument("--algorithm-provider", default="CUDAProvider")
    p.add_argument(
        "--config", default="",
        help="versioned KubeSchedulerConfiguration file "
        "(componentconfig/v1alpha1); wins over flags",
    )
    p.add_argument(
        "--leader-elect", action="store_true",
        help="participate in kube-scheduler leader election: "
        "only the lease holder schedules; standbys take over "
        "when the holder dies (scheduler HA)",
    )
    p.add_argument("--leader-elect-identity", default="",
                   help="lease holder identity (defaults to a "
                   "per-process id)")
    p.add_argument("--lease-duration", type=float, default=15.0)
    p.add_argument("--renew-deadline", type=float, default=10.0)
    p.add_argument("--retry-period", type=float, default=2.0)
    p.add_argument(
        "--serve-port", type=int, default=None,
        help="observability mux port (/healthz /metrics; "
        "0 = ephemeral, unset = disabled for daemon use)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device of the scheduler (cpu runs it on "
                   "the host)")

    p = sub.add_parser("controller-manager")
    add_client_flags(p)

    p = sub.add_parser("kubelet")
    add_client_flags(p)
    p.add_argument("--node", required=True)
    p.add_argument(
        "--fake-runtime", action=argparse.BooleanOptionalAction,
        default=False,
        help="hollow-node mode: instant in-memory containers instead of "
        "real processes",
    )
    p.add_argument(
        "--serve-api", action="store_true",
        help="serve the node API (logs/exec/stats) and register its "
        "endpoint on the Node status",
    )
    p.add_argument("--tls-cert-file", default="",
                   help="serve the node API over TLS")
    p.add_argument("--tls-private-key-file", default="")
    p.add_argument(
        "--auth-token", default="",
        help="require `Authorization: Bearer <token>` on the node API "
        "(an open /exec on a process runtime is remote code execution)",
    )
    p.add_argument(
        "--config", default="",
        help="versioned KubeletConfiguration file "
        "(componentconfig/v1alpha1); file fields win over flags",
    )

    p = sub.add_parser("extender")
    p.add_argument("--port", type=int, default=8090)
    p.add_argument("--device", default="cuda",
                   help="torch device of the program (cpu runs it on the "
                   "host)")

    p = sub.add_parser("proxy")
    add_client_flags(p)
    p.add_argument("--node", default="")

    p = sub.add_parser("federation-apiserver")
    p.add_argument("--port", type=int, default=8180)

    p = sub.add_parser("federation-controller-manager")
    p.add_argument("--server", "-s", default="http://127.0.0.1:8180")

    # kubefed join/unjoin (federation/cmd/kubefed): register/remove a
    # member cluster in the federated apiserver
    p = sub.add_parser("kubefed")
    p.add_argument("action", choices=["join", "unjoin"])
    p.add_argument("name")
    p.add_argument("--server", "-s", default="http://127.0.0.1:8180",
                   help="the FEDERATED apiserver")
    p.add_argument("--cluster-endpoint", default="",
                   help="member apiserver URL (join)")

    p = sub.add_parser("local-up")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--nodes", type=int, default=3)
    p.add_argument("--algorithm-provider", default="CUDAProvider")
    p.add_argument("--device", default="cuda",
                   help="torch device of the scheduler (cpu runs it on "
                   "the host)")
    p.add_argument("--data-dir", default="",
                   help="persist the apiserver store (WAL + snapshot)")
    p.add_argument("--dns-port", type=int, default=0,
                   help="kube-dns UDP+TCP port (0 = ephemeral; 53 needs root)")
    p.add_argument(
        "--real-nodes", type=int, default=0,
        help="additionally run N kubelets on the PROCESS runtime: pods "
        "scheduled there run as live OS processes",
    )
    p.add_argument(
        "--cloud-provider", default="local",
        choices=["local", "multizone"],
        help="cloud provider behind the controller-manager: 'local' "
        "(live byte-forwarding LBs) or 'multizone' (simulated regional "
        "cloud: zonal disks, async attach, per-zone LB frontends)",
    )

    args = ap.parse_args(argv)
    import os

    prof_path = os.environ.get("KUBERNETES_TPU_PROFILE", "")
    if prof_path:
        # perf diagnosis for daemon subprocesses: a low-overhead stack
        # sampler over every thread (cProfile is per-thread and not
        # safe to share across a threaded server); SIGTERM — the
        # harness's shutdown signal — dumps the tally as text.
        import collections
        import threading
        import traceback

        samples = collections.Counter()

        def _sample():
            while True:
                for frame in list(sys._current_frames().values()):
                    stack = traceback.extract_stack(frame)[-3:]
                    key = " <- ".join(
                        f"{f.name}@{f.filename.rsplit('/', 1)[-1]}"
                        f":{f.lineno}"
                        for f in reversed(stack)
                    )
                    samples[key] += 1
                time.sleep(0.005)

        threading.Thread(target=_sample, daemon=True,
                         name="profile-sampler").start()

        def _dump(*_a):
            # snapshot with retry: the sampler thread keeps inserting,
            # and a "dict changed size" escape here would swallow the
            # shutdown signal entirely
            for _ in range(50):
                try:
                    snap = dict(samples)
                    break
                except RuntimeError:
                    continue
            else:
                snap = {}
            with open(prof_path, "w") as f:
                for k, v in sorted(
                    snap.items(), key=lambda kv: -kv[1]
                )[:60]:
                    f.write(f"{v:6d}  {k}\n")
            os._exit(0)

        signal.signal(signal.SIGTERM, _dump)
    {
        "apiserver": run_apiserver,
        "federation-apiserver": run_federation_apiserver,
        "federation-controller-manager": run_federation_controller_manager,
        "kubefed": run_kubefed,
        "extender": run_extender,
        "scheduler": run_scheduler,
        "controller-manager": run_controller_manager,
        "kubelet": run_kubelet,
        "proxy": run_proxy,
        "local-up": run_local_up,
    }[args.component](args)


if __name__ == "__main__":
    main()
