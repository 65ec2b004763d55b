"""Event broker — FSM-commit change events fanned out to subscribers.

Reference: ``nomad/stream/event_broker.go:30-49`` (EventBroker holding an
``eventBuffer`` ring; per-subscriber ``subscription`` cursors with topic
filtering) + ``ndjson.go`` (the `/v1/event/stream` encoding, which
belongs to an HTTP layer this package does not have yet).

Events are published by the state store as mutations commit (the same
place the reference hooks memdb txns), carrying *references* to the
store's immutable objects — serialization cost is paid per-subscriber at
stream time, not per-commit.

A copy of the reference package's broker without its TSan hooks.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

TOPIC_ALL = "*"

# Topics (reference: structs/event.go TopicJob/TopicAlloc/...).
TOPIC_JOB = "Job"
TOPIC_EVAL = "Evaluation"
TOPIC_ALLOC = "Allocation"
TOPIC_NODE = "Node"
TOPIC_DEPLOYMENT = "Deployment"


@dataclass
class Event:
    topic: str
    type: str  # e.g. JobRegistered, AllocationUpdated, NodeDeregistered
    key: str  # primary id
    namespace: str = "default"
    index: int = 0
    payload: Any = None  # store object reference (immutable discipline)

    def to_wire(self) -> Dict:
        from ..structs import serde

        try:
            payload = serde.to_wire(self.payload)
        except TypeError:
            payload = repr(self.payload)
        return {
            "Topic": self.topic,
            "Type": self.type,
            "Key": self.key,
            "Namespace": self.namespace,
            "Index": self.index,
            "Payload": payload,
        }


class Subscription:
    def __init__(self, broker: "EventBroker", topics: Dict[str, List[str]]):
        self.broker = broker
        self.topics = topics  # topic -> list of keys ("*" = all)
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self.closed = False

    def _matches(self, ev: Event) -> bool:
        for topic in (ev.topic, TOPIC_ALL):
            keys = self.topics.get(topic)
            if keys is None:
                continue
            if TOPIC_ALL in keys or ev.key in keys:
                return True
        return False

    def _offer(self, events: List[Event]) -> None:
        take = [e for e in events if self._matches(e)]
        if not take:
            return
        with self._cond:
            self._queue.extend(take)
            self._cond.notify_all()

    def next(self, timeout: Optional[float] = None) -> List[Event]:
        """Block for the next batch of matching events ([] on timeout or
        close)."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._queue or self.closed, timeout=timeout
            )
            out = list(self._queue)
            self._queue.clear()
            return out

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()
        self.broker._unsubscribe(self)


class EventBroker:
    def __init__(self, buffer_size: int = 4096):
        self._lock = threading.Lock()
        self._buffer: deque = deque(maxlen=buffer_size)
        self._subs: List[Subscription] = []
        self.latest_index = 0
        # Highest index known to be unservable from the backlog: events
        # evicted from the ring, plus (after a restart) all pre-restore
        # history — restore does not re-publish, so a reconnecting
        # subscriber with a pre-restart cursor must see a gap marker.
        # A ``from_index`` at or below this cannot be served gaplessly.
        self._dropped_through = 0

    def mark_history_truncated(self, through_index: int) -> None:
        """Declare that no event with index <= ``through_index`` can be
        replayed (called by the store after a WAL/snapshot restore)."""
        with self._lock:
            if through_index > self._dropped_through:
                self._dropped_through = through_index

    def publish(self, events: List[Event]) -> None:
        if not events:
            return
        with self._lock:
            maxlen = self._buffer.maxlen
            for e in events:
                if maxlen is not None and len(self._buffer) == maxlen:
                    evicted = self._buffer[0]
                    if evicted.index > self._dropped_through:
                        self._dropped_through = evicted.index
                self._buffer.append(e)
            if events[-1].index > self.latest_index:
                self.latest_index = events[-1].index
            subs = list(self._subs)
        for sub in subs:
            sub._offer(events)

    def subscribe(
        self,
        topics: Optional[Dict[str, List[str]]] = None,
        from_index: int = 0,
    ) -> Subscription:
        """Subscribe to topics ({topic: [keys]}, default everything).
        ``from_index`` > 0 replays buffered events newer than it first.

        When events newer than ``from_index`` have already been evicted
        from the ring, the replay is *gapped*: the subscription's first
        event is a synthetic ``Framework/EventStreamGap`` control event
        (bypassing topic filters) telling the consumer the earliest index
        the backlog actually covers, so it can resync with a list call
        instead of silently consuming a history with a hole in it.
        """
        sub = Subscription(self, topics or {TOPIC_ALL: [TOPIC_ALL]})
        with self._lock:
            if from_index:
                if self._dropped_through > from_index:
                    gap = Event(
                        topic="Framework",
                        type="EventStreamGap",
                        key="",
                        index=self._dropped_through,
                        payload={
                            "requested_index": from_index,
                            "dropped_through": self._dropped_through,
                        },
                    )
                    with sub._cond:
                        sub._queue.append(gap)
                sub._offer(
                    [e for e in self._buffer if e.index > from_index]
                )
            self._subs.append(sub)
        return sub

    def _unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)
