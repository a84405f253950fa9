"""Webhook connectors (a copy of ``predictionio_tpu/api/webhooks.py``;
reference: data/.../api/Webhooks*.scala +
webhooks/segmentio/mailchimp connectors — SURVEY.md §2 'Event server').

A connector turns a third-party JSON or form payload into the canonical
Event.  POST /webhooks/<name>.json?accessKey=K dispatches to the registered
connector; unknown names 404 like the reference.

**Extension point** (this is the whole integration contract): a connector
is any ``Callable[[Mapping], Event]`` — raise ``ValueError`` for a payload
you cannot map.  Register it before the event server starts:

    from predictionio_tpu_torch.api.webhooks import register_connector
    def my_connector(payload):
        return Event(event=payload["action"], entity_type="user",
                     entity_id=str(payload["uid"]))
    register_connector("mysystem", my_connector)

after which ``POST /webhooks/mysystem.json?accessKey=K`` ingests that
system's payloads.  The reference shipped exactly this shape as a small
family of bundled connectors (segmentio JSON, mailchimp form); both are
built in below, and anything else is one function away.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

from predictionio_tpu_torch.events.event import DataMap, Event

Connector = Callable[[Mapping], Event]

_CONNECTORS: Dict[str, Connector] = {}


def register_connector(name: str, connector: Connector) -> None:
    _CONNECTORS[name] = connector


def get_connector(name: str):
    return _CONNECTORS.get(name)


def connectors() -> Dict[str, Connector]:
    return dict(_CONNECTORS)


# -- built-in: segment.io (reference: webhooks/segmentio/SegmentIOConnector) --


def segmentio_connector(payload: Mapping) -> Event:
    """Maps a segment.com track/identify/page/screen call to an Event."""
    typ = payload.get("type")
    user = payload.get("userId") or payload.get("anonymousId")
    if not typ or not user:
        raise ValueError("segmentio payload requires 'type' and 'userId'/'anonymousId'")
    timestamp = payload.get("timestamp") or payload.get("sentAt")
    props = DataMap(payload.get("properties") or payload.get("traits") or {})
    if typ == "track":
        name = payload.get("event")
        if not name:
            raise ValueError("segmentio 'track' requires 'event'")
        return Event(event=name, entity_type="user", entity_id=str(user),
                     properties=props, event_time=timestamp)
    if typ in ("identify", "page", "screen", "alias", "group"):
        return Event(event=typ, entity_type="user", entity_id=str(user),
                     properties=props, event_time=timestamp)
    raise ValueError(f"unsupported segmentio type {typ!r}")


register_connector("segmentio", segmentio_connector)


# -- built-in: generic form connector (reference: WebhooksConnectors.forms) --


def form_connector(payload: Mapping) -> Event:
    """Accepts flat form fields: event, entityType, entityId [,target...]"""
    try:
        return Event(
            event=str(payload["event"]),
            entity_type=str(payload["entityType"]),
            entity_id=str(payload["entityId"]),
            target_entity_type=payload.get("targetEntityType"),
            target_entity_id=payload.get("targetEntityId"),
            properties=DataMap({
                k: v for k, v in payload.items()
                if k not in ("event", "entityType", "entityId",
                             "targetEntityType", "targetEntityId", "eventTime")
            }),
            event_time=payload.get("eventTime"),
        )
    except KeyError as e:
        raise ValueError(f"form payload missing {e}")


register_connector("form", form_connector)


# -- built-in: mailchimp (reference: webhooks/mailchimp/MailChimpConnector) --


def mailchimp_connector(payload: Mapping) -> Event:
    """Maps MailChimp webhook notifications (subscribe/unsubscribe/
    profile/cleaned/upemail/campaign) to Events, mirroring the reference
    connector: the list member is the entity; the notification type is
    the event verb; the flattened data[...] form fields are properties.

    MailChimp posts form-encoded ``type=subscribe&data[email]=…`` bodies;
    the event server's form decoding (or a JSON re-post) delivers them
    here as a flat mapping with bracketed keys.
    """
    typ = payload.get("type")
    if not typ:
        raise ValueError("mailchimp payload requires 'type'")
    known = ("subscribe", "unsubscribe", "profile", "cleaned", "upemail",
             "campaign")
    if typ not in known:
        raise ValueError(f"unsupported mailchimp type {typ!r}")
    # data[...] fields arrive either nested ({"data": {...}}) or flattened
    # ("data[email]": ...) depending on the posting agent
    data = payload.get("data")
    if not isinstance(data, Mapping):
        data = {k[5:-1]: v for k, v in payload.items()
                if k.startswith("data[") and k.endswith("]")}
    entity = (data.get("email") or data.get("new_email")
              or data.get("id") or data.get("list_id"))
    if not entity:
        raise ValueError(
            "mailchimp payload carries no member email/id to key the event")
    props = {k: v for k, v in data.items()}
    if payload.get("fired_at"):
        props["fired_at"] = payload["fired_at"]
    return Event(event=typ, entity_type="user", entity_id=str(entity),
                 properties=DataMap(props),
                 event_time=_mailchimp_time(payload.get("fired_at")))


def _mailchimp_time(fired_at):
    """MailChimp's 'YYYY-MM-DD HH:MM:SS' (UTC, no zone) → ISO-8601.
    A value that already looks ISO (a 'T', a zone suffix) — e.g. from a
    normalizing JSON re-poster — passes through untouched."""
    if not fired_at:
        return None
    s = str(fired_at)
    if "T" in s or s.endswith("Z") or "+" in s:
        return s
    return s.replace(" ", "T") + "+00:00"


register_connector("mailchimp", mailchimp_connector)
