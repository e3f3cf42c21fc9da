"""Fleet lifecycle: first-class node states on the shared timeline.

The paper's deployment story (§VII, "hundreds of machines") is won or
lost in the provisioning layer: nodes are not eternal.  This module owns
node *membership* for one ``drive_fleet`` run — previously inlined
pool-dict bookkeeping in the driver — as an explicit state machine:

    BOOTING ──boot_s elapses──▶ SERVING ──ledger removal──▶ DRAINING
       │                          │                            │
       └────────── kill ──────────┴──────── kill / drained ────┴──▶ DEAD

  * **BOOTING** — the node is materialized (billed!) but serves nothing
    until its spec's ``boot_s`` elapses.  Nodes present when the run
    starts are warm; nodes added later (autoscaling, fault restart) pay
    the boot delay.
  * **SERVING** — the only state routers ever see: ``drive_fleet`` routes
    each window across ``FleetController.serving()``.
  * **DRAINING** — removed from the ledger by an autoscaler: receives no
    new queries but finishes its assigned work (live nodes keep
    advancing on the wall clock until the final drain).  A draining node
    lingers unbilled until the run ends; if the ledger names its key
    again (the pool regrows) the drain is *cancelled* and it resumes
    warm — scale-in-protection semantics.  Under a :class:`SelfHealPolicy`
    with ``terminate_idle`` the controller instead *terminates* a
    DRAINING node once its accepted work completes: the backend is
    closed mid-run (a remote node's OS process actually exits) rather
    than lingering to the end of the run.
  * **SUSPECT** — transport degraded (an RPC deadline expired and the
    socket was scrapped) but the process may be alive: the health pass
    verifies (ping over a fresh connection) and either reinstates the
    node or declares it DEAD.  A transient state — it appears in the
    event log, never across windows.
  * **DEAD** — killed by a :class:`FleetFaults` plan, or detected dead
    by the per-window health pass / a failed submit (``BackendDied``):
    the backend's ``cancel_pending`` hook surrenders its unfinished
    queries, and the controller hands them back to the driver for
    *re-routing* to the surviving SERVING nodes (or drops them when
    ``reroute=False`` — the ablation baseline).  A ``restart_after_s``
    schedule — or, for unplanned deaths, the :class:`SelfHealPolicy`'s
    crash-loop budget — re-materializes the node later, through BOOTING
    like any cold node.

Both engines run the same controller: ``SimNodeBackend.cancel_pending``
rolls analytic completions past the kill instant back out of its history;
``LiveNodeBackend.cancel_pending`` shuts its ``ServingRuntime`` down
mid-run.  Kills land at the first window boundary at or after their
trace time (detection is windowed, like any health check), and a
``cluster.chaos.ChaosPlan`` extends the fault plan with transport chaos
(hung RPCs, garbled frames) delivered to backends at the same
boundaries.
"""
from __future__ import annotations

import dataclasses
import enum

from repro_torch.cluster.backend import NodeBackend, PendingQuery
from repro_torch.cluster.fleet import Fleet, NodeView


class NodeState(enum.Enum):
    BOOTING = "booting"
    SERVING = "serving"
    DRAINING = "draining"
    # transport degraded (an RPC deadline expired) but the process may be
    # alive: the health pass verifies and either clears the node back to
    # its previous state or declares it DEAD — SUSPECT appears in the
    # event log as the verdict's paper trail, never as a rest state
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class NodeKill:
    """Kill one node at trace time ``t_s``.  With ``restart_after_s`` the
    node re-materializes that many seconds after the kill — as a fresh
    backend, through BOOTING, paying its spec's ``boot_s``."""
    t_s: float
    pool: str
    index_in_pool: int
    restart_after_s: float | None = None

    @property
    def key(self) -> tuple[str, int]:
        return (self.pool, self.index_in_pool)


@dataclasses.dataclass(frozen=True)
class FleetFaults:
    """Fleet-level fault plan — whole-node kills at trace times, driving
    both engines through the one ``FleetController``.  ``reroute=False``
    drops a killed node's unfinished queries instead of re-routing them
    to survivors (what the resilience benchmark compares against).
    Orthogonal to ``core.simulator.FaultConfig``, which models
    *intra-node* faults (stragglers, request failures) in the event
    engine.

    In fleet mode kills are written back to the ``Fleet`` ledger
    (``Fleet.kill`` — node identity is ledger-owned via ``Pool.members``,
    so removing an exact index never renames survivors): an autoscaler
    sharing the pool sees the true post-kill capacity on its utilization
    trigger, and regrowth reuses the dead index for its replacement
    node."""
    kills: tuple[NodeKill, ...] = ()
    reroute: bool = True


@dataclasses.dataclass(frozen=True)
class SelfHealPolicy:
    """Self-healing discipline for the lifecycle controller.

    *Auto-restart*: a node that dies **unplanned** (the health pass's
    ``backend.dead()`` probe, or a driver-detected mid-submit death) —
    or is killed by a fault plan with no explicit ``restart_after_s`` —
    is re-materialized through the normal BOOTING → SERVING path, at
    most ``max_restarts`` times per node key, with exponential backoff
    in *trace seconds* between attempts (crash-loop protection: a node
    that dies every window must not consume the run respawning).

    *Terminate-after-idle* (``terminate_idle``): a DRAINING node whose
    accepted work has all completed is closed and retired at the next
    window boundary — its real resources (an OS process, for remote
    nodes) are released mid-run instead of lingering until the run ends.
    Restarts need the fleet+factory mode; with explicit backends the
    policy still buys health detection, orphan re-route, and
    terminate-after-idle."""
    max_restarts: int = 3
    backoff_s: float = 0.0
    backoff_factor: float = 2.0
    backoff_cap_s: float = 30.0
    terminate_idle: bool = True

    def delay_s(self, used: int) -> float:
        if self.backoff_s <= 0:
            return 0.0
        return min(self.backoff_s * self.backoff_factor ** used,
                   self.backoff_cap_s)


@dataclasses.dataclass(frozen=True)
class LifecycleEvent:
    """One state transition, for ``ClusterResult.lifecycle`` reports."""
    t_s: float
    pool: str
    index_in_pool: int
    state: NodeState


@dataclasses.dataclass
class _Node:
    backend: NodeBackend
    state: NodeState
    serve_at: float


class FleetController:
    """Materializes, boots, drains, retires, and kills node backends for
    one ``drive_fleet`` run (see module docstring).

    Two ownership modes, mirroring the driver's:

      * ``fleet`` + ``factory`` — the ledger names the nodes; the
        controller materializes backends lazily per window and owns them
        (``close_all``).  Autoscaler mutations are picked up by
        ``reconcile``; fault restarts re-materialize through the factory.
      * ``backends`` — an explicit caller-owned node list (the live
        tier).  Kills work; restarts need a factory and are rejected.
    """

    def __init__(self, *, fleet: Fleet | None = None, factory=None,
                 backends: list[NodeBackend] | None = None,
                 faults: FleetFaults | None = None,
                 heal: SelfHealPolicy | None = None):
        if (backends is None) == (fleet is None):
            raise ValueError("pass exactly one of backends= or fleet=+factory=")
        if fleet is not None and factory is None:
            raise ValueError("fleet mode needs a backend factory(view, t0)")
        self.fleet = fleet
        self.factory = factory
        self.faults = faults or FleetFaults()
        self.heal = heal
        if backends is not None and any(
                k.restart_after_s is not None for k in self.faults.kills):
            raise ValueError("restart_after_s needs the fleet=+factory= "
                             "mode — an explicit backend list gives the "
                             "controller no way to build a replacement node")
        self.realtime: bool | None = None
        self.events: list[LifecycleEvent] = []
        self._nodes: dict[tuple, _Node] = {}
        self._order: list[tuple] = []          # insertion order (explicit)
        self._dead: dict[tuple, float | None] = {}   # key → restart due
        self._graveyard: list[NodeBackend] = []      # killed backends
        self._kills = sorted(self.faults.kills, key=lambda k: k.t_s)
        self._next_kill = 0
        # transport/boot chaos injections (a ChaosPlan's hangs + garbles),
        # delivered to backends' inject_chaos hooks at window boundaries;
        # plain FleetFaults has none
        inj = getattr(self.faults, "injections", None)
        self._injections = list(inj()) if callable(inj) else []
        self._next_inject = 0
        self._restarts: dict[tuple, int] = {}  # key → heal budget used
        self._owned = fleet is not None
        self._explicit = list(backends or [])
        # membership revision: bumped on every state transition, it keys
        # the serving-list / billable-count caches — at fleet scale the
        # per-window O(nodes) rebuild was pure driver overhead (nothing
        # changes in the vast majority of windows)
        self._rev = 0
        self._serving_cache: tuple | None = None
        self._billable_cache: tuple | None = None

    # ------------------------------------------------------------ plumbing

    def _fold_kind(self, batch: list[NodeBackend]) -> None:
        kinds = {b.realtime for b in batch}
        if self.realtime is not None:
            kinds.add(self.realtime)
        if len(kinds) > 1:
            raise ValueError("cannot mix realtime and simulated backends "
                             "on one timeline")
        if kinds:
            self.realtime = kinds.pop()

    def _transition(self, t: float, key: tuple, state: NodeState) -> None:
        self.events.append(LifecycleEvent(t, key[0], key[1], state))
        self._rev += 1

    def _materialize(self, view: NodeView, t: float, *, warm: bool) -> None:
        b = self.factory(view, t)
        self._fold_kind([b])
        if self.realtime:
            b.start(t)
        key = (view.pool, view.index_in_pool)
        boot = 0.0 if warm else float(view.spec.boot_s)
        state = NodeState.SERVING if boot <= 0 else NodeState.BOOTING
        if state is NodeState.SERVING and not self._ready(b):
            # an async boot-ahead backend: the order returned instantly
            # but the process isn't serving yet — BOOTING until ready()
            state = NodeState.BOOTING
        self._nodes[key] = _Node(b, state, t + boot)
        self._order.append(key)
        self._transition(t, key, state)

    @staticmethod
    def _ready(b: NodeBackend) -> bool:
        ready = getattr(b, "ready", None)
        return ready() if callable(ready) else True

    def _view_keys(self) -> list[tuple]:
        if self.fleet is not None:
            return [(v.pool, v.index_in_pool) for v in self.fleet.node_views()]
        return list(self._order)

    # ------------------------------------------------------------ protocol

    def start(self, t0: float) -> None:
        """Materialize the initial fleet, warm (nodes present at the start
        of a run don't pay ``boot_s`` — only nodes added mid-run do)."""
        if self._explicit:
            keys = set()
            for b in self._explicit:
                if b.key in keys:
                    raise ValueError(
                        f"duplicate backend identity {b.key}: give each "
                        f"node a distinct (pool, index_in_pool)")
                keys.add(b.key)
            self._fold_kind(self._explicit)
            for b in self._explicit:
                if self.realtime:
                    b.start(t0)
                self._nodes[b.key] = _Node(b, NodeState.SERVING, t0)
                self._order.append(b.key)
                self._transition(t0, b.key, NodeState.SERVING)
        else:
            for v in self.fleet.node_views():
                self._materialize(v, t0, warm=True)
            # async-booted initial nodes: the run cannot begin before the
            # starting fleet exists, so block here (the factory's pool
            # overlaps the spawns) and promote each node that came up —
            # boot-ahead pays off on *mid-run* orders, not the first fleet
            for key, node in self._nodes.items():
                wait = getattr(node.backend, "wait_ready", None)
                if callable(wait) and node.state is NodeState.BOOTING \
                        and node.serve_at <= t0 + 1e-9 and wait():
                    node.state = NodeState.SERVING
                    self._transition(t0, key, NodeState.SERVING)

    def begin_window(self, t: float
                     ) -> tuple[list[NodeBackend], list[PendingQuery]]:
        """Advance the lifecycle to window start ``t``: restart dead nodes
        whose schedule came due, materialize ledger additions (BOOTING),
        promote BOOTING nodes whose delay elapsed, and apply kills whose
        trace time has arrived.  Returns the SERVING node list routers
        may see plus the killed nodes' unfinished queries (empty unless a
        kill landed this window)."""
        # fault restarts that came due (fleet mode only): re-provisioning
        # a dead machine puts its index back in the ledger first — kills
        # were written out of it — then boots a fresh backend cold
        # (ulp tolerance, like boot promotion below: the due instant is a
        # different float-add chain than the window grid)
        for key, due in list(self._dead.items()):
            if due is not None and due <= t + 1e-9:
                del self._dead[key]
                if key in self._nodes:
                    continue      # the pool regrew into this slot meanwhile
                self.fleet.restore(key[0], key[1])
                p = self.fleet.pool(key[0])
                view = NodeView(pool=key[0], index_in_pool=key[1],
                                spec=p.spec,
                                weight=max(p.qps_capacity, 1e-9))
                self._materialize(view, t, warm=False)
        # ledger additions (autoscaler growth), cold — except a key whose
        # node is still DRAINING from an earlier shrink: the ledger naming
        # it again cancels the drain (the backend never stopped, so it
        # resumes SERVING warm rather than colliding with a fresh twin).
        # The ledger's view list is cached on membership (``Fleet.node_views``)
        # — the same object as last window means no ledger mutation, so the
        # whole additions scan is skipped
        vlist = self.fleet.node_views() if self.fleet else []
        if vlist is getattr(self, "_seen_views", None):
            views = {}
        else:
            self._seen_views = vlist
            views = {(v.pool, v.index_in_pool): v for v in vlist}
        for key, v in views.items():
            node = self._nodes.get(key)
            if node is not None:
                if node.state is NodeState.DRAINING:
                    # a node drained mid-boot resumes the rest of its boot
                    back = (NodeState.SERVING
                            if node.serve_at <= t + 1e-9
                            else NodeState.BOOTING)
                    node.state = back
                    self._transition(t, key, back)
            else:
                # growth may refill a killed slot (Fleet.scale hands out
                # the lowest free index): the ledger naming a dead key
                # again means a fresh replacement node — cancel any
                # scheduled restart, it would now be a duplicate
                self._dead.pop(key, None)
                self._materialize(v, t, warm=False)
        # boot promotions (ulp tolerance: serve_at is built by a different
        # float-add chain than the window grid, and a last-bit excess must
        # not defer the promotion by a whole window).  An async-booting
        # node additionally needs its spawn future resolved (ready) —
        # until then it stays BOOTING, billed but invisible to routers.
        for key, node in self._nodes.items():
            if node.state is NodeState.BOOTING \
                    and node.serve_at <= t + 1e-9 \
                    and self._ready(node.backend):
                node.state = NodeState.SERVING
                self._transition(t, key, NodeState.SERVING)
        # kills whose trace time arrived (cancel at the kill instant —
        # analytic completions past it never happened)
        orphans: list[PendingQuery] = []
        while (self._next_kill < len(self._kills)
               and self._kills[self._next_kill].t_s <= t):
            kill = self._kills[self._next_kill]
            self._next_kill += 1
            orphans += self._kill(kill)
        orphans += self._health_pass(t)
        self._dispatch_chaos(t)
        self._terminate_idle(t)
        return self.serving(), orphans

    def _kill(self, kill: NodeKill) -> list[PendingQuery]:
        node = self._nodes.pop(kill.key, None)
        matched = node is not None
        if self.fleet is not None:
            try:
                # ledger-owned identity: the death is a ledger fact — the
                # autoscaler's utilization trigger must see the true pool
                matched |= self.fleet.kill(kill.pool, kill.index_in_pool)
            except KeyError:
                pass                     # kill plan names an unknown pool
        if not matched:
            # the plan names a node that never existed (typo'd index or
            # pool): nothing died, and scheduling a restart would later
            # materialize a phantom node the fleet never had
            return []
        if kill.restart_after_s is not None:
            self._dead[kill.key] = kill.t_s + kill.restart_after_s
        elif node is not None and node.state is not NodeState.DRAINING:
            # no explicit restart schedule: the heal policy (if any)
            # decides — this is what the auto-restart-off ablation turns
            # off.  A DRAINING victim is never healed: the autoscaler
            # removed it deliberately.
            self._schedule_restart(kill.key, kill.t_s)
        else:
            self._dead[kill.key] = None
        if kill.key in self._order:
            self._order.remove(kill.key)
        if node is None:
            return []                    # never materialized / already dead
        self._transition(kill.t_s, kill.key, NodeState.DEAD)
        orphans = node.backend.cancel_pending(kill.t_s)
        self._graveyard.append(node.backend)
        return orphans

    def _schedule_restart(self, key: tuple, t: float) -> None:
        """Dead-node disposition under the heal policy: schedule a
        re-materialization ``backoff`` trace-seconds out while the node's
        crash-loop budget lasts; past it (or without a policy/factory)
        the node stays dead."""
        heal = self.heal
        if heal is None or self.factory is None:
            self._dead[key] = None
            return
        used = self._restarts.get(key, 0)
        if used >= heal.max_restarts:
            self._dead[key] = None       # crash-loop budget exhausted
            return
        self._restarts[key] = used + 1
        self._dead[key] = t + heal.delay_s(used)

    def _node_died(self, key: tuple, t: float) -> list[PendingQuery]:
        """Retire a node that died *unplanned* (health probe or a failed
        submit): write the death back to the ledger, surrender its
        unfinished queries for re-routing, and let the heal policy decide
        whether it restarts."""
        node = self._nodes.pop(key, None)
        if node is None:
            return []
        if key in self._order:
            self._order.remove(key)
        if self.fleet is not None:
            try:
                self.fleet.kill(key[0], key[1])
            except KeyError:
                pass
        self._transition(t, key, NodeState.DEAD)
        try:
            orphans = node.backend.cancel_pending(t)
        except Exception:
            orphans = []                 # already gone past recovery
        self._graveyard.append(node.backend)
        if node.state is NodeState.DRAINING:
            self._dead[key] = None       # retired anyway; don't revive
        else:
            self._schedule_restart(key, t)
        return orphans

    def node_died(self, key: tuple, t: float) -> list[PendingQuery]:
        """Public form of the unplanned-death path, for the driver: a
        ``submit``/poll raised ``BackendDied`` mid-window, before the
        next health pass would have noticed."""
        return self._node_died(key, t)

    def _health_pass(self, t: float) -> list[PendingQuery]:
        """Poll every node's health: dead backends are retired (their
        orphans re-routed, heal policy deciding on a restart); SUSPECT
        backends — transport degraded but the process may live — are
        verified and either cleared back or declared dead."""
        orphans: list[PendingQuery] = []
        for key, node in list(self._nodes.items()):
            b = node.backend
            try:
                is_dead = b.dead()
            except Exception:
                is_dead = True
            if is_dead:
                orphans += self._node_died(key, t)
                continue
            if getattr(b, "suspect", False) and node.state in (
                    NodeState.SERVING, NodeState.DRAINING):
                prev = node.state
                node.state = NodeState.SUSPECT
                self._transition(t, key, NodeState.SUSPECT)
                verify = getattr(b, "verify", None)
                if verify is None or verify():
                    node.state = prev    # false alarm: reinstated
                    self._transition(t, key, prev)
                else:
                    orphans += self._node_died(key, t)
        return orphans

    def _dispatch_chaos(self, t: float) -> None:
        """Deliver due chaos injections (a ``ChaosPlan``'s hangs and
        garbles) to their targets' ``inject_chaos`` hooks.  Backends
        without the hook (sim, live) have no transport to fault — the
        injection is a no-op on them."""
        while (self._next_inject < len(self._injections)
               and self._injections[self._next_inject].t_s <= t):
            ev = self._injections[self._next_inject]
            self._next_inject += 1
            node = self._nodes.get(ev.key)
            if node is None:
                continue                 # target already dead/retired
            hook = getattr(node.backend, "inject_chaos", None)
            if callable(hook):
                hook(ev)

    def _terminate_idle(self, t: float) -> None:
        """Terminate-after-idle (heal policy): a DRAINING node whose
        accepted work has all completed is closed *now* — its process /
        runtime is released mid-run — and recorded DEAD, instead of
        lingering until the run ends."""
        if self.heal is None or not self.heal.terminate_idle:
            return
        for key, node in list(self._nodes.items()):
            if node.state is not NodeState.DRAINING:
                continue
            try:
                if not node.backend.idle(t):
                    continue
            except Exception:
                pass                     # unreachable counts as idle
            self._nodes.pop(key)
            if key in self._order:
                self._order.remove(key)
            node.backend.close()
            self._graveyard.append(node.backend)
            self._dead[key] = None
            self._transition(t, key, NodeState.DEAD)

    def finish(self, horizon: float) -> list[PendingQuery]:
        """Apply kills that landed after the last window boundary (their
        orphans can only be dropped — no windows remain to re-route in)."""
        orphans: list[PendingQuery] = []
        while (self._next_kill < len(self._kills)
               and self._kills[self._next_kill].t_s <= horizon):
            kill = self._kills[self._next_kill]
            self._next_kill += 1
            orphans += self._kill(kill)
        return orphans

    def drain(self, key: tuple, t: float) -> None:
        """Retire one node gracefully: it stops receiving queries but
        finishes the work already assigned to it (live nodes keep
        advancing until the final drain).  The graceful half of a kill —
        nothing is orphaned."""
        node = self._nodes.get(key)
        if node is not None and node.state in (NodeState.BOOTING,
                                               NodeState.SERVING):
            node.state = NodeState.DRAINING
            self._transition(t, key, NodeState.DRAINING)

    def reconcile(self, t: float) -> None:
        """Pick up ledger mutations (autoscaler shrink): nodes the fleet
        no longer names stop receiving queries but finish their assigned
        work — DRAINING, not dropped."""
        if self.fleet is None:
            return
        alive = {(v.pool, v.index_in_pool) for v in self.fleet.node_views()}
        for key in list(self._nodes):
            if key not in alive:
                self.drain(key, t)

    # ------------------------------------------------------------- queries

    def serving(self) -> list[NodeBackend]:
        """The router-visible fleet, in ledger order (fleet mode) or
        insertion order (explicit backends).

        Cached against the transition revision (and the ledger's cached
        view list, which a pure ledger mutation swaps): steady-state
        windows return the *same list object*, which downstream callers
        (the grouped driver path) use as their own cache key.  Callers
        must treat the returned list as read-only."""
        views = self.fleet.node_views() if self.fleet is not None else None
        c = self._serving_cache
        if c is not None and c[0] == self._rev and c[1] is views:
            return c[2]
        out = [self._nodes[k].backend for k in self._view_keys()
               if k in self._nodes
               and self._nodes[k].state is NodeState.SERVING]
        self._serving_cache = (self._rev, views, out)
        return out

    def advance_targets(self) -> list[NodeBackend]:
        """Realtime nodes that must track the window boundary: SERVING
        plus DRAINING (still finishing assigned work)."""
        return [n.backend for n in self._nodes.values()
                if n.state in (NodeState.SERVING, NodeState.DRAINING)]

    def all_created(self) -> list[NodeBackend]:
        """Every backend this run ever materialized, dead ones included —
        the final record-collection (and close) set."""
        return [n.backend for n in self._nodes.values()] + self._graveyard

    def states(self) -> dict[tuple, NodeState]:
        out = {k: n.state for k, n in self._nodes.items()}
        for k in self._dead:
            out[k] = NodeState.DEAD
        return out

    def state_counts(self) -> dict[str, int]:
        """Node count per lifecycle state — the per-window fleet-shape
        gauges the telemetry layer snapshots (``booting_nodes`` etc.)."""
        out: dict[str, int] = {}
        for s in self.states().values():
            out[s.name] = out.get(s.name, 0) + 1
        return out

    @property
    def billable_n(self) -> int:
        """Nodes billed for the current window: BOOTING (you pay for an
        instance from the moment it is provisioned) + SERVING.  DRAINING
        remainders and the dead are free, matching the pre-lifecycle
        driver's accounting."""
        c = self._billable_cache
        if c is not None and c[0] == self._rev:
            return c[1]
        n = sum(node.state in (NodeState.BOOTING, NodeState.SERVING)
                for node in self._nodes.values())
        self._billable_cache = (self._rev, n)
        return n

    @property
    def n_nodes(self) -> int:
        return self.billable_n

    def pool_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for k, n in self._nodes.items():
            if n.state in (NodeState.BOOTING, NodeState.SERVING):
                out[k[0]] = out.get(k[0], 0) + 1
        return out

    def close_all(self) -> None:
        """Release every owned backend (fleet mode: the caller never saw
        them).  Explicit backends stay the caller's to close."""
        if not self._owned:
            return
        for b in self.all_created():
            b.close()
