"""Raft-lite replicated control plane: WAL streaming, election, failover.

Reference: the reference replicates all state writes through hashicorp/raft
(``nomad/fsm.go``, ``nomad/raft_rpc.go:1-134``) and drives leader-only
services from election transitions (``monitorLeadership``,
``nomad/leader.go:54-222``).

This build replicates the same ``(index, seq, op, args)`` entry stream the
WAL already journals (state/wal.py) over the existing HTTP wire:

- **Log replication.** The leader ships each entry to every peer and
  blocks for a majority of acks before the write applies or returns.  An
  acknowledged write therefore exists on a quorum; an unacknowledged
  write may be lost on failover but its submitter saw an error — the
  primary-backup variant of raft's commit rule.
- **Election.** Term-based voting with randomized timeouts. A vote is
  granted only to candidates whose log is at least as long (``last_seq``),
  so any winner holds every majority-acked entry (the vote majority and
  the ack majority intersect — raft's safety argument, §5.4.1 of the
  paper, applied to the seq axis).
- **Catch-up.** A follower that is merely behind gets the missing suffix
  re-sent from the leader's log ring; one whose position the ring no
  longer covers gets a full snapshot install
  (``StateStore.to_snapshot_wire``).
- **Transitions.** Winning an election calls
  ``server.establish_leadership()`` (brokers, workers, watchers, timers);
  observing a higher term calls ``server.revoke_leadership()``.

Writes on non-leaders raise :class:`NotLeaderError` carrying the leader's
address; ``api.rpc.FailoverRPC`` follows the hint so clients survive
failovers transparently.

A copy of the reference package's ``server/replication.py``, its
``raft.send`` chaos seam included: it fires in :meth:`Replicator._post`,
once for each message to one peer (``src``/``dst`` in its ctx), so a
``match={"dst": ...}`` schedule cuts exactly one link.  Differences,
each for a leader whose followers hold a large state (thousands of nodes,
whose image takes seconds to install):

- A follower installs an image through ``server.install_snapshot``, which
  stops its workers and waits for its dry runs before the matrix is
  cleared: a leader demoted a moment earlier may still be selecting.
- The leader installs images on a catch-up thread of the peer, so its
  heartbeats to the other peers go on meanwhile (the reference installs
  inline in the heartbeat loop, and a peer starved of heartbeats for the
  install's length campaigns).  The image and its seq are captured under
  the store's write lock, so no write is between its quorum and its apply
  when the image is taken.  The transfer has its own timeout
  (``SNAPSHOT_TIMEOUT``).  Writes do not wait on an installing peer; it
  counts toward the heartbeat quorum (it answered in this term) for at
  most ``INSTALL_GRACE_TIMEOUTS`` election timeouts from the start of its
  install, so a leader cut off from the rest steps down as the
  reference's does, only later.  Each heartbeat round posts to every
  peer at once.
- A follower does not campaign while it applies the leader's stream, nor
  from the moment it asks its leader for a snapshot (an image takes
  seconds to build and send, and the leader sends no heartbeat to a peer
  it is installing) until the install or another append from a leader
  arrives, or the same grace passes with no message from the leader; a
  follower that far behind could not win an election while its leader
  lives.  Its election timer restarts when an apply ends.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .. import trace
from ..chaos import inject
from ..retry import Backoff, RetryPolicy, env_float

log = logging.getLogger(__name__)

# Operators (and the test suite) can widen every raft timer under CPU
# contention: timeouts of 0.25-0.5s with 80ms heartbeats flap when a loaded
# machine delays scheduler threads past the election window.
TIMEOUT_SCALE = env_float("NOMAD_TPU_RAFT_TIMEOUT_SCALE", 1.0)

# Recent entries retained in memory for follower catch-up by re-send
# (log repair) instead of full-snapshot install.
LOG_RING_CAPACITY = 4096

# Seconds a snapshot install may take, transfer and the follower's
# restore included: an image of tens of thousands of nodes takes seconds.
SNAPSHOT_TIMEOUT = 300.0

# Election timeouts (the longer bound) for which a snapshot install keeps
# its peer in the leader's heartbeat quorum, and keeps a follower that
# asked for an image from campaigning.
INSTALL_GRACE_TIMEOUTS = 10

_POST_ERRORS = (urllib.error.URLError, OSError, json.JSONDecodeError)


class NotLeaderError(Exception):
    def __init__(self, leader_addr: str = ""):
        super().__init__(
            f"not the leader{f' (leader at {leader_addr})' if leader_addr else ''}"
        )
        self.leader_addr = leader_addr


class ReplicationError(Exception):
    """A write could not reach a quorum — it is NOT committed."""


@dataclass
class PeerState:
    addr: str
    healthy: bool = True
    last_error: str = ""
    # Failed peers are skipped by the write path until this monotonic
    # time; the heartbeat loop keeps probing and clears it on success, so
    # one dead peer costs writes a single timeout per cooldown window
    # instead of one per write.  The window grows per consecutive failure
    # through the shared backoff policy (retry.py) and snaps back on the
    # first success.
    retry_after: float = 0.0
    backoff: Optional[Backoff] = None

    def mark_failed(self, error: str) -> None:
        self.healthy = False
        self.last_error = error
        delay = self.backoff.next_delay() if self.backoff else 0.5
        self.retry_after = time.monotonic() + delay

    def mark_ok(self) -> None:
        self.healthy = True
        self.retry_after = 0.0
        if self.backoff is not None:
            self.backoff.reset()


class Replicator:
    """One per server; owns role/term state and the peer stream."""

    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"

    def __init__(
        self,
        server,
        server_id: str,
        self_addr: str,
        peer_addrs: List[str],
        election_timeout: tuple = (0.25, 0.5),
        heartbeat_interval: float = 0.08,
        rpc_timeout: float = 5.0,
        append_timeout: float = 1.5,
        peer_cooldown: float = 0.5,
        cluster_secret: str = "",
        state_dir: Optional[str] = None,
    ):
        self.server = server
        self.id = server_id
        self.self_addr = self_addr
        # Per-peer resend cooldown: base = the configured cooldown,
        # growing exponentially while a peer stays dead so the write path
        # doesn't pay a probe per window to a long-gone server.
        self._peer_retry_policy = RetryPolicy(
            base_delay=peer_cooldown,
            max_delay=max(peer_cooldown * 8, 2.0),
            jitter=0.25,
        )
        self.peers: Dict[str, PeerState] = {
            a: self._new_peer(a) for a in peer_addrs if a and a != self_addr
        }
        s = TIMEOUT_SCALE
        self.election_timeout = (election_timeout[0] * s,
                                 election_timeout[1] * s)
        self.heartbeat_interval = heartbeat_interval * s
        self.install_grace = INSTALL_GRACE_TIMEOUTS * self.election_timeout[1]
        self.rpc_timeout = rpc_timeout
        self.append_timeout = append_timeout
        # Shared secret authenticating server↔server raft RPCs (an
        # unauthenticated /v1/internal/raft/snapshot could otherwise replace
        # the whole cluster state).  Sent on every peer RPC; checked by the
        # HTTP layer before routing to the handlers below.
        self.cluster_secret = cluster_secret

        self._lock = threading.RLock()
        # Serializes follower-side stream application (append/snapshot).
        # Lock order: _stream_lock → store._write_lock → store._lock;
        # _lock is only ever held briefly for role/term/seq fields and
        # NEVER while taking a store lock (the journaled write path holds
        # store._write_lock and takes _lock inside replicate(), so the
        # reverse order would be an ABBA deadlock across leadership
        # changes).
        self._stream_lock = threading.Lock()
        self.role = self.FOLLOWER
        self.term = 0
        self.voted_for: Optional[str] = None
        # Hard state (term, voted_for) persists across restarts (raft §5.1:
        # a server that re-votes in a term it already voted in can elect two
        # leaders).  None = diskless (tests/sim) — memory only.
        self._state_path = (
            os.path.join(state_dir, "raft_state.json") if state_dir else None
        )
        self._load_hard_state()
        self.leader_id: Optional[str] = None
        self.leader_addr: str = ""
        # Log position: mirrors the WAL sequence (authoritative when a WAL
        # is attached; tracked here for diskless test servers).
        wal = server.store.wal
        self.last_seq = wal.seq if wal is not None else 0
        # Recent entries by seq, for catch-up by re-send: a follower that
        # is merely behind gets the missing suffix re-shipped instead of a
        # full snapshot install (hashicorp/raft's pipeline replication
        # repairs the same way; snapshots only when the log has been
        # compacted past the follower's position).
        self._log_ring: "OrderedDict[int, Dict]" = OrderedDict()
        self._last_heartbeat = time.monotonic()
        # Follower: no campaign before this monotonic time — it asked its
        # leader for a snapshot (see the module docstring).
        self._awaiting_snapshot_until = 0.0
        # Leader: the snapshot install in flight per peer address, and the
        # monotonic time it started.
        self._catch_ups: Dict[str, threading.Thread] = {}
        self._catch_up_started: Dict[str, float] = {}
        # Observability: how followers were caught up (tests + stats).
        self.repair_resends = 0  # leader: suffix re-sends that succeeded
        self.snapshots_installed = 0  # follower: full-image installs

        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        t = threading.Thread(
            target=self._election_loop, name=f"raft-election-{self.id}",
            daemon=True,
        )
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads + list(self._catch_ups.values()):
            t.join(timeout=5)
        self._threads.clear()

    @property
    def is_leader(self) -> bool:
        return self.role == self.LEADER

    def quorum(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    def update_peers(self, addrs) -> None:
        """Apply a membership change (server join/leave): reconcile the
        live peer map against the full member address list, preserving
        the health state of peers that remain."""
        with self._lock:
            want = {a for a in addrs if a and a != self.self_addr}
            for a in list(self.peers):
                if a not in want:
                    del self.peers[a]
            for a in want:
                if a not in self.peers:
                    self.peers[a] = self._new_peer(a)

    def _new_peer(self, addr: str) -> PeerState:
        return PeerState(
            addr=addr, backoff=Backoff(self._peer_retry_policy)
        )

    def ensure_leader(self) -> None:
        if not self.is_leader:
            raise NotLeaderError(self.leader_addr)

    # ------------------------------------------------------------------
    # Hard state (raft §5.1: currentTerm + votedFor survive restarts)
    # ------------------------------------------------------------------

    def _load_hard_state(self) -> None:
        if self._state_path and os.path.exists(self._state_path):
            try:
                with open(self._state_path) as fh:
                    st = json.load(fh)
                self.term = int(st.get("term", 0))
                self.voted_for = st.get("voted_for") or None
                return
            except (OSError, ValueError) as exc:
                log.warning("raft hard state unreadable: %s", exc)

    def _persist_hard_state_locked(self) -> None:
        """Write (term, voted_for) durably BEFORE acting on them — a vote
        response must not be sent until the vote cannot be forgotten."""
        if not self._state_path:
            return
        tmp = self._state_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"term": self.term, "voted_for": self.voted_for}, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._state_path)

    # ------------------------------------------------------------------
    # Log ring (catch-up by re-send instead of snapshot install)
    # ------------------------------------------------------------------

    def _ring_add_locked(self, entry: Dict) -> None:
        self._log_ring[entry["s"]] = entry
        while len(self._log_ring) > LOG_RING_CAPACITY:
            self._log_ring.popitem(last=False)

    def _ring_suffix(self, from_seq: int) -> Optional[List[Dict]]:
        """Entries (from_seq, last_seq], or None if the ring has been
        compacted past from_seq (then only a snapshot can repair)."""
        with self._lock:
            want = range(from_seq + 1, self.last_seq + 1)
            if not all(s in self._log_ring for s in want):
                return None
            return [self._log_ring[s] for s in want]

    # ------------------------------------------------------------------
    # Peer RPC plumbing (HTTP; the same wire the agents already speak)
    # ------------------------------------------------------------------

    def _post(
        self, addr: str, path: str, payload: Dict,
        timeout: Optional[float] = None,
    ) -> Dict:
        # Chaos seam: the partition primitive.  Matching on src/dst cuts
        # specific links (asymmetric partitions included); sustained drops
        # on the append path starve followers of heartbeats and force
        # elections.  "dup" replays an entry append (the PrevSeq check on
        # the receiver must reject the stale duplicate).  Every post goes
        # to one peer, so the seam fires once per peer and message.
        fault = inject("raft.send", path=path, src=self.id, dst=addr)
        trace.event("seam.raft.send", path=path, dst=addr)
        if fault is not None and fault.kind == "drop":
            raise urllib.error.URLError("injected partition")
        data = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        if self.cluster_secret:
            headers["X-Nomad-Cluster-Secret"] = self.cluster_secret

        def post_once() -> Dict:
            req = urllib.request.Request(
                addr + path, data=data, method="POST", headers=headers,
            )
            with urllib.request.urlopen(
                req, timeout=timeout or self.rpc_timeout
            ) as resp:
                return json.loads(resp.read() or b"{}")

        if fault is not None and fault.kind == "dup":
            post_once()
        return post_once()

    def _installing(self, addr: str) -> bool:
        t = self._catch_ups.get(addr)
        return t is not None and t.is_alive()

    def _post_to_peers(self, peers: List[PeerState], send) -> Dict[str, bool]:
        """``send(peer)`` for every peer at once; a peer's result is
        False when its post outlasts the append window."""
        results: Dict[str, bool] = {}

        def run(p: PeerState) -> None:
            results[p.addr] = send(p)

        threads = [
            threading.Thread(target=run, args=(p,), daemon=True)
            for p in peers
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.append_timeout + 1.0)
        return results

    # ------------------------------------------------------------------
    # Leader: entry replication (called from the store's journal hook)
    # ------------------------------------------------------------------

    def replicate(self, entry: Dict) -> None:
        """Ship one journaled entry to the peers; block for quorum-1 acks
        (the leader's own append is the +1).  Raises
        :class:`ReplicationError` when a quorum is unreachable — the write
        must fail rather than be acknowledged uncommitted."""
        with self._lock:
            if self.role != self.LEADER:
                raise NotLeaderError(self.leader_addr)
            term = self.term
            prev_seq = self.last_seq
        if not self.peers:
            with self._lock:
                self.last_seq = entry["s"]
                self._ring_add_locked(entry)
            return
        needed = self.quorum()
        # Concurrent posts (not sequential — the caller holds the store's
        # write lock, so per-write latency is max(RTT) not sum); peers in
        # their failure cooldown or taking a snapshot are skipped.
        now = time.monotonic()
        eligible = [
            p for p in list(self.peers.values())
            if now >= p.retry_after and not self._installing(p.addr)
        ]
        results = self._post_to_peers(eligible, lambda p: self._send_entries(
            p, term, prev_seq, [entry], allow_snapshot=False
        ))
        acks = 1 + sum(1 for ok in results.values() if ok)
        if acks < needed:
            # Lost quorum: the entry is NOT committed — last_seq stays at
            # prev_seq (it was never advanced) so the log position still
            # matches the WAL/store. Step down so an up-to-date peer can
            # take over.
            self._step_down(term, reason="lost replication quorum")
            raise ReplicationError(
                f"entry seq={entry['s']} acked by {acks}/{needed} servers"
            )
        with self._lock:
            self.last_seq = entry["s"]
            self._ring_add_locked(entry)

    def _send_entries(
        self, peer: PeerState, term: int, prev_seq: int, entries: List[Dict],
        allow_snapshot: bool = True,
    ) -> bool:
        try:
            out = self._post(peer.addr, "/v1/internal/raft/append", {
                "Term": term,
                "LeaderID": self.id,
                "LeaderAddr": self.self_addr,
                "PrevSeq": prev_seq,
                "Entries": entries,
            }, timeout=self.append_timeout)
        except _POST_ERRORS as exc:
            peer.mark_failed(str(exc))
            return False
        if out.get("Term", 0) > term:
            self._observe_term(out["Term"])
            return False
        if out.get("NeedSnapshot"):
            # Log repair first: if the follower is merely BEHIND (its seq
            # is a prefix of ours still in the ring), re-send the missing
            # suffix — far cheaper than a snapshot install, and the only
            # path a healthy-but-slow follower should ever take.  A
            # diverged follower (ahead of us, or compacted past) still
            # needs the full FSM image.
            peer_seq = int(out.get("Seq", -1))
            with self._lock:
                behind = 0 <= peer_seq < self.last_seq
            if behind:
                suffix = self._ring_suffix(peer_seq)
                if suffix is not None:
                    try:
                        out2 = self._post(
                            peer.addr, "/v1/internal/raft/append", {
                                "Term": term,
                                "LeaderID": self.id,
                                "LeaderAddr": self.self_addr,
                                "PrevSeq": peer_seq,
                                # Suffix covers (peer_seq, last_seq]; the
                                # in-flight entries (not yet in the ring)
                                # ride along so an ack means the follower
                                # really holds them.
                                "Entries": suffix + entries,
                            }, timeout=self.rpc_timeout,
                        )
                    except _POST_ERRORS as exc:
                        peer.mark_failed(str(exc))
                        return False
                    if out2.get("OK"):
                        peer.mark_ok()
                        with self._lock:
                            self.repair_resends += 1
                        log.info("caught %s up by re-send (%d entries)",
                                 peer.addr, len(suffix))
                        return True
            # The write path must NOT install inline: its caller serializes
            # writes, and a full state transfer would stall them all.
            # The heartbeat loop does the catch-up, on the peer's own
            # thread, so the other peers' heartbeats go on.
            if not allow_snapshot:
                peer.healthy = False
                peer.last_error = "needs snapshot catch-up"
                return False
            self._start_catch_up(peer, term)
            return True
        if out.get("OK"):
            peer.mark_ok()
        else:
            peer.healthy = False
        return peer.healthy

    def _start_catch_up(self, peer: PeerState, term: int) -> None:
        with self._lock:
            if self._installing(peer.addr):
                return
            t = threading.Thread(
                target=self._install_snapshot, args=(peer, term),
                name=f"raft-catch-up-{peer.addr}", daemon=True,
            )
            self._catch_ups[peer.addr] = t
            self._catch_up_started[peer.addr] = time.monotonic()
        t.start()

    def _install_snapshot(self, peer: PeerState, term: int) -> bool:
        """Catch a lagging/diverged follower up with the full FSM image
        (fsm.go:1367 Persist / raft InstallSnapshot analog)."""
        store = self.server.store
        # Capture (image, seq) atomically, but post OUTSIDE the store locks —
        # a multi-second network transfer under them would stall every
        # read.  The write lock too: a writer holds it from its quorum to
        # its apply, and an image taken in between would carry the
        # entry's seq without the entry.
        with store._write_lock, store._lock:
            snap = store.to_snapshot_wire()
            seq = self.last_seq
        try:
            out = self._post(peer.addr, "/v1/internal/raft/snapshot", {
                "Term": term,
                "LeaderID": self.id,
                "LeaderAddr": self.self_addr,
                "Seq": seq,
                "Snapshot": snap,
            }, timeout=SNAPSHOT_TIMEOUT)
            ok = bool(out.get("OK"))
            if ok:
                peer.mark_ok()
                log.info("installed snapshot (seq=%d) on %s", seq, peer.addr)
            else:
                peer.healthy = False
            return ok
        except _POST_ERRORS as exc:
            peer.mark_failed(str(exc))
            return False

    # ------------------------------------------------------------------
    # Follower: stream handlers (HTTP endpoints route here)
    # ------------------------------------------------------------------

    def handle_append(self, body: Dict) -> Dict:
        term = int(body.get("Term", 0))
        entries = body.get("Entries", [])
        prev_seq = int(body.get("PrevSeq", 0))
        with self._stream_lock:
            with self._lock:
                if term < self.term:
                    return {"OK": False, "Term": self.term}
                self._observe_leader_locked(
                    term, body.get("LeaderID", ""),
                    body.get("LeaderAddr", ""),
                )
                if entries:
                    ok_prefix = prev_seq == self.last_seq
                else:
                    # Heartbeats tolerate being ahead of the leader's view:
                    # the leader advances its last_seq only after quorum,
                    # so a follower that just applied seq N legitimately
                    # sees a heartbeat still stamped PrevSeq N-1.
                    ok_prefix = self.last_seq >= prev_seq
                if not ok_prefix:
                    self._awaiting_snapshot_until = (
                        time.monotonic() + self.install_grace
                    )
                    return {
                        "OK": False, "Term": self.term,
                        "NeedSnapshot": True, "Seq": self.last_seq,
                    }
                self._awaiting_snapshot_until = 0.0
            # Apply OUTSIDE self._lock (lock order: _stream_lock →
            # store locks; never a store lock under _lock — see __init__).
            for e in entries:
                self.server.store.apply_remote(e)
                with self._lock:
                    self.last_seq = e["s"]
                    # Followers keep the ring too: a freshly elected leader
                    # must be able to repair its peers by re-send.
                    self._ring_add_locked(e)
            with self._lock:
                self._last_heartbeat = time.monotonic()
                return {"OK": True, "Term": self.term, "Seq": self.last_seq}

    def handle_snapshot_install(self, body: Dict) -> Dict:
        term = int(body.get("Term", 0))
        with self._stream_lock:
            with self._lock:
                if term < self.term:
                    return {"OK": False, "Term": self.term}
                self._observe_leader_locked(
                    term, body.get("LeaderID", ""),
                    body.get("LeaderAddr", ""),
                )
            # The server's install stops its workers and waits for its dry
            # runs before the store clears the matrix (see the module
            # docstring); it takes no leadership, this server follows.
            self.server.install_snapshot(
                body["Snapshot"], int(body.get("Seq", 0))
            )
            with self._lock:
                self.last_seq = int(body.get("Seq", 0))
                self.snapshots_installed += 1
                # The ring predates the install; anything in it no longer
                # matches the new log position.
                self._log_ring.clear()
                self._last_heartbeat = time.monotonic()
                self._awaiting_snapshot_until = 0.0
                return {"OK": True, "Term": self.term}

    def handle_vote(self, body: Dict) -> Dict:
        term = int(body.get("Term", 0))
        candidate = body.get("CandidateID", "")
        cand_seq = int(body.get("LastSeq", 0))
        with self._lock:
            if term < self.term:
                return {"Granted": False, "Term": self.term}
            if term > self.term:
                # A higher term deposes us regardless of how we learn of
                # it (raft §5.1) — without the step-down, a leader that
                # merely OBSERVES a higher-term vote request would keep
                # role=leader at the new term: same-term split brain.
                self._new_term_locked(term)
                if self.role != self.FOLLOWER:
                    self._become_follower_locked()
            up_to_date = cand_seq >= self.last_seq
            grant = self.voted_for in (None, candidate) and up_to_date
            if grant:
                self.voted_for = candidate
                # Durable BEFORE the response leaves: a restart must not
                # forget this vote (raft §5.1).
                self._persist_hard_state_locked()
                self._last_heartbeat = time.monotonic()
            return {"Granted": grant, "Term": self.term}

    # ------------------------------------------------------------------
    # Role transitions
    # ------------------------------------------------------------------

    def _observe_leader_locked(
        self, term: int, leader_id: str, leader_addr: str
    ) -> None:
        if term > self.term:
            self._new_term_locked(term)
        if self.role != self.FOLLOWER:
            self._become_follower_locked()
        self.leader_id = leader_id
        self.leader_addr = leader_addr
        self._last_heartbeat = time.monotonic()

    def _observe_term(self, term: int) -> None:
        with self._lock:
            if term > self.term:
                self._new_term_locked(term)
                self._become_follower_locked()

    def _new_term_locked(self, term: int) -> None:
        self.term = term
        self.voted_for = None
        self._persist_hard_state_locked()

    def _become_follower_locked(self) -> None:
        was_leader = self.role == self.LEADER
        self.role = self.FOLLOWER
        if was_leader:
            log.info("%s: stepping down (term %d)", self.id, self.term)
            threading.Thread(
                target=self.server.revoke_leadership, daemon=True
            ).start()

    def _step_down(self, term: int, reason: str) -> None:
        with self._lock:
            if self.role == self.LEADER and self.term == term:
                log.warning("%s: %s", self.id, reason)
                self._become_follower_locked()

    def _become_leader(self, term: int) -> None:
        with self._lock:
            if self.term != term or self.role != self.CANDIDATE:
                return
            self.role = self.LEADER
            self.leader_id = self.id
            self.leader_addr = self.self_addr
        log.info("%s: elected leader (term %d, seq %d)",
                 self.id, term, self.last_seq)
        t = threading.Thread(
            target=self._heartbeat_loop, args=(term,),
            name=f"raft-heartbeat-{self.id}", daemon=True,
        )
        t.start()
        self._threads.append(t)
        self.server.establish_leadership()

    # ------------------------------------------------------------------
    # Timers
    # ------------------------------------------------------------------

    def _election_loop(self) -> None:
        while not self._stop.is_set():
            timeout = random.uniform(*self.election_timeout)
            self._stop.wait(timeout / 4)
            with self._lock:
                role = self.role
                now = time.monotonic()
                stale = (now - self._last_heartbeat > timeout
                         and now >= self._awaiting_snapshot_until)
            # A follower applying the leader's stream (a long re-send or
            # a snapshot install) has heard from it: no campaign.
            if role != self.LEADER and stale and not self._stream_lock.locked():
                self._campaign()

    def _campaign(self) -> None:
        with self._lock:
            self.term += 1
            term = self.term
            self.role = self.CANDIDATE
            self.voted_for = self.id
            self._persist_hard_state_locked()
            self._last_heartbeat = time.monotonic()
            last_seq = self.last_seq
        votes = 1
        for peer in list(self.peers.values()):
            try:
                out = self._post(peer.addr, "/v1/internal/raft/vote", {
                    "Term": term,
                    "CandidateID": self.id,
                    "LastSeq": last_seq,
                })
            except _POST_ERRORS:
                continue
            if out.get("Term", 0) > term:
                self._observe_term(out["Term"])
                return
            if out.get("Granted"):
                votes += 1
        if votes >= self.quorum():
            self._become_leader(term)

    def _heartbeat_loop(self, term: int) -> None:
        while not self._stop.is_set():
            with self._lock:
                if self.role != self.LEADER or self.term != term:
                    return
                prev_seq = self.last_seq
            peers = list(self.peers.values())
            # A peer taking a snapshot answered this term already; it gets
            # no heartbeat until the install ends, and counts as alive for
            # the install's first install_grace seconds.
            installing = [p for p in peers if self._installing(p.addr)]
            now = time.monotonic()
            results = self._post_to_peers(
                [p for p in peers if p not in installing],
                lambda p: self._send_entries(p, term, prev_seq, []),
            )
            alive = 1 + sum(
                1 for p in installing
                if now - self._catch_up_started[p.addr] < self.install_grace
            ) + sum(1 for ok in results.values() if ok)
            if alive < self.quorum():
                # Can't reach a quorum: stop acting as leader so a
                # connected majority can elect (and our stale writes fail).
                self._step_down(term, reason="lost heartbeat quorum")
                return
            self._stop.wait(self.heartbeat_interval)

    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "ID": self.id,
                "Role": self.role,
                "Term": self.term,
                "LastSeq": self.last_seq,
                "LeaderID": self.leader_id or "",
                "LeaderAddr": self.leader_addr,
                "Peers": {
                    a: {"Healthy": p.healthy, "LastError": p.last_error}
                    for a, p in self.peers.items()
                },
            }
