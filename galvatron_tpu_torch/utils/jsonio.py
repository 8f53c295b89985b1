"""JSON config IO helpers (reference: galvatron/utils/config_utils.py:14-20)."""

import json
import os


def read_json_config(path):
    with open(path, "r", encoding="utf-8") as fp:
        return json.load(fp)


def write_json_config(config, path):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fp:
        json.dump(config, fp, indent=4)
        fp.write("\n")
