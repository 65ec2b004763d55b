"""Change-event stream (reference: ``nomad/stream/``)."""

from .broker import Event, EventBroker, Subscription, TOPIC_ALL

__all__ = ["Event", "EventBroker", "Subscription", "TOPIC_ALL"]
