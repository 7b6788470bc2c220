"""Built-in application plugins (the Python plugin plane).

Each app is a generator function ``main(api, args)`` speaking the
SyscallAPI.  The registry resolves config ``<plugin path>`` strings of the
form ``python:<name>`` (or a bare name) to the app callable; native ``.so``
paths are handled by the native plugin plane (later rounds).
"""

from . import registry  # noqa: F401
