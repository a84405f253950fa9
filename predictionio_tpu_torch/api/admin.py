"""Admin REST API (a copy of ``predictionio_tpu/api/admin.py``; reference:
tools/src/main/scala/io/prediction/tools/admin/
AdminAPI.scala — app/access-key management over HTTP; SURVEY.md §2 'Admin
API').

  GET    /                       {"status": "alive"}
  GET    /cmd/app                list apps
  POST   /cmd/app                {"name": ..., "description": ...} create
  DELETE /cmd/app/<name>         delete app (+keys/channels/events)
  DELETE /cmd/app/<name>/data    wipe event data
  GET    /cmd/app/<name>/accesskeys      list keys
  POST   /cmd/app/<name>/accesskeys      {"events": [...]} create key
"""

from __future__ import annotations

import json
import logging
from typing import Optional

from predictionio_tpu_torch.api.http_util import JsonHandler, start_server
from predictionio_tpu_torch.storage.base import AccessKey, App
from predictionio_tpu_torch.storage.locator import Storage, get_storage

log = logging.getLogger("pio.admin")


def make_handler(storage: Storage):
    class AdminHandler(JsonHandler):
        def do_GET(self):
            path, _ = self.route
            if path == "/":
                self.send_json({"status": "alive"})
            elif path == "/cmd/app":
                self.send_json({
                    "apps": [
                        {"name": a.name, "id": a.id, "description": a.description}
                        for a in storage.apps.get_all()
                    ]
                })
            elif path.startswith("/cmd/app/") and path.endswith("/accesskeys"):
                name = path[len("/cmd/app/"):-len("/accesskeys")]
                app = storage.apps.get_by_name(name)
                if app is None:
                    self.send_error_json(404, f"app {name!r} not found")
                    return
                self.send_json({
                    "accessKeys": [
                        {"key": k.key, "events": k.events}
                        for k in storage.access_keys.get_by_app_id(app.id)
                    ]
                })
            else:
                self.send_error_json(404, "not found")

        def do_POST(self):
            path, _ = self.route
            try:
                body = self.read_json() or {}
            except json.JSONDecodeError as e:
                self.send_error_json(400, f"invalid JSON: {e}")
                return
            if path == "/cmd/app":
                name = body.get("name")
                if not name:
                    self.send_error_json(400, "missing app name")
                    return
                app_id = storage.apps.insert(App(int(body.get("id", 0)), name,
                                                 body.get("description", "")))
                if app_id is None:
                    self.send_error_json(409, f"app {name!r} already exists")
                    return
                storage.l_events.init(app_id)
                key = storage.access_keys.insert(AccessKey("", app_id, []))
                self.send_json({"status": 1, "id": app_id, "name": name,
                                "accessKey": key}, status=201)
            elif path.startswith("/cmd/app/") and path.endswith("/accesskeys"):
                name = path[len("/cmd/app/"):-len("/accesskeys")]
                app = storage.apps.get_by_name(name)
                if app is None:
                    self.send_error_json(404, f"app {name!r} not found")
                    return
                key = storage.access_keys.insert(
                    AccessKey("", app.id, list(body.get("events", [])))
                )
                self.send_json({"accessKey": key}, status=201)
            else:
                self.send_error_json(404, "not found")

        def do_DELETE(self):
            path, _ = self.route
            if path.startswith("/cmd/app/") and path.endswith("/data"):
                name = path[len("/cmd/app/"):-len("/data")]
                app = storage.apps.get_by_name(name)
                if app is None:
                    self.send_error_json(404, f"app {name!r} not found")
                    return
                storage.l_events.remove(app.id)
                storage.l_events.init(app.id)
                self.send_json({"status": 1})
            elif path.startswith("/cmd/app/"):
                name = path[len("/cmd/app/"):]
                app = storage.apps.get_by_name(name)
                if app is None:
                    self.send_error_json(404, f"app {name!r} not found")
                    return
                for k in storage.access_keys.get_by_app_id(app.id):
                    storage.access_keys.delete(k.key)
                for c in storage.channels.get_by_app_id(app.id):
                    storage.l_events.remove(app.id, c.id)
                    storage.channels.delete(c.id)
                storage.l_events.remove(app.id)
                storage.apps.delete(app.id)
                self.send_json({"status": 1})
            else:
                self.send_error_json(404, "not found")

    return AdminHandler


def run_admin_server(
    host: str = "127.0.0.1",
    port: int = 7071,
    storage: Optional[Storage] = None,
    background: bool = False,
):
    storage = storage or get_storage()
    httpd = start_server(make_handler(storage), host, port, background=background)
    log.info("Admin server listening on %s:%d", host, httpd.server_address[1])
    if background:
        return httpd
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0
