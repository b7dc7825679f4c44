"""Shared reading of a JAX launcher's flags from its source (not run),
for the port's launcher tests (``tests/test_torch_launch_*.py``)."""
import ast
from pathlib import Path


def reference_flags(path: Path) -> dict:
    """{flag: (default, action)} of every ``add_argument`` in the JAX
    launcher's source at `path`."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            default = eval(compile(ast.Expression(kw["default"]), "", "eval"),
                           {}) if "default" in kw else None
            if kw.get("action") is not None:
                action = ast.literal_eval(kw["action"])
                if action == "store_true" and "default" not in kw:
                    default = False
            else:
                action = None
            out[node.args[0].value] = (default, action)
    return out
