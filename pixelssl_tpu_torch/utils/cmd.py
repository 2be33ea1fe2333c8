"""Dict config -> argv -> argparse (counterpart of
``pixelssl_tpu/utils/cmd.py``; reference pixelssl/utils/cmd.py:10-59).

An experiment script defines an ``OrderedDict``; ``parse_args`` writes it
out as command-line flags and parses them with the parser that every layer
added its flags to, so ``--help`` works and a real command line can
override any key. Dict flags are Python literals (``ast.literal_eval``):
a script passes real dicts, and ``str(dict)`` is one. Where a value is not
one, it is read as a YAML flow mapping, as the JAX package reads every
dict flag (``yaml.full_load``), without PyYAML: ``{model: pspnet}``.
"""

import argparse
import ast
import re
import sys

from . import logger


def parse_args(parser, config=None, cli_override=True):
    """Parse ``config`` as argv; with ``cli_override`` the process's own
    ``sys.argv[1:]`` follows it and wins. A tool with its own command line
    passes ``False``, or its flags would reach this parser, where argparse's
    prefix matching can bind them to lookalikes. Unknown flags are logged
    and ignored."""
    argv = []
    if config is not None:
        for key, value in config.items():
            argv.append('--' + str(key).replace('_', '-'))
            argv.append(str(value))
    if cli_override:
        argv += sys.argv[1:]
    args, unknown = parser.parse_known_args(argv)
    for token in unknown:
        if token.startswith('--'):
            logger.log_warn('Unknown argument: {0}'.format(token))
    return args


def print_args(args):
    logger.log_info('Arguments:')
    for key, value in sorted(vars(args).items()):
        logger.log_info('  {0:<28}: {1}'.format(key, value))


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ('yes', 'true', 't', 'y', '1'):
        return True
    if v.lower() in ('no', 'false', 'f', 'n', '0'):
        return False
    raise ValueError('Unsupported value encountered: {0}'.format(v))


def str2intlist(v):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    v = v.strip().strip('[]()')
    return [int(x) for x in v.split(',') if x.strip() != '']


def str2floatlist(v):
    if isinstance(v, (list, tuple)):
        return [float(x) for x in v]
    v = v.strip().strip('[]()')
    return [float(x) for x in v.split(',') if x.strip() != '']


def strdict(v):
    """A dict flag: a dict, a Python literal of one, or a YAML flow
    mapping (``_FlowYaml``)."""
    if isinstance(v, dict):
        return v
    try:
        value = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        try:
            value = _FlowYaml(v).document()
        except ValueError as exc:
            raise argparse.ArgumentTypeError(
                'dict expected, got {0!r}: {1}'.format(v, exc))
    if not isinstance(value, dict):
        raise argparse.ArgumentTypeError(
            'dict expected, got {0!r}'.format(v))
    return value


# PyYAML's implicit resolvers (YAML 1.1, resolver.py), which
# ``yaml.full_load`` applies to plain scalars. A float needs a dot, and the
# sign of an exponent: ``1e-3`` stays a string.
_YAML_BOOL = re.compile(r'^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false'
                        r'|False|FALSE|on|On|ON|off|Off|OFF)$')
_YAML_NULL = re.compile(r'^(?:~|null|Null|NULL|)$')
_YAML_INT = re.compile(r'^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)'
                       r'|[-+]?0x[0-9a-fA-F_]+'
                       r'|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$')
_YAML_FLOAT = re.compile(r'^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?'
                         r'|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?'
                         r'|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*'
                         r'|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$')
_YAML_ESCAPES = {'0': '\0', 'a': '\a', 'b': '\b', 't': '\t', '\t': '\t',
                 'n': '\n', 'v': '\v', 'f': '\f', 'r': '\r', 'e': '\x1b',
                 ' ': ' ', '"': '"', '/': '/', '\\': '\\'}


def _sexagesimal(text, number):
    value = 0
    for part in text.split(':'):
        value = value * 60 + number(part)
    return value


def _yaml_int(text):
    text = text.replace('_', '')
    sign = -1 if text[0] == '-' else 1
    text = text.lstrip('+-')
    if text == '0':
        return 0
    if text.startswith('0b'):
        return sign * int(text[2:], 2)
    if text.startswith('0x'):
        return sign * int(text[2:], 16)
    if ':' in text:
        return sign * _sexagesimal(text, int)
    if text[0] == '0':
        return sign * int(text, 8)
    return sign * int(text)


def _yaml_float(text):
    text = text.replace('_', '').lower()
    sign = -1.0 if text[0] == '-' else 1.0
    text = text.lstrip('+-')
    if text == '.inf':
        return sign * float('inf')
    if text == '.nan':
        return float('nan')
    if ':' in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _yaml_plain(text):
    """A plain scalar resolved as ``yaml.full_load`` resolves it (dates
    stay strings)."""
    if _YAML_NULL.match(text):
        return None
    if _YAML_BOOL.match(text):
        return text.lower() in ('yes', 'true', 'on')
    if _YAML_INT.match(text):
        return _yaml_int(text)
    if _YAML_FLOAT.match(text):
        return _yaml_float(text)
    return text


class _FlowYaml(object):
    """A YAML flow collection: ``{...}`` mappings and ``[...]`` sequences
    of plain, single- or double-quoted scalars, nested. ``document()``
    returns its value; a syntax error raises ``ValueError``."""

    _END = ',[]{}'

    def __init__(self, text):
        self.s, self.i = text, 0

    def document(self):
        self._space()
        if self._peek() != '{':
            raise ValueError('a flow mapping starts with "{"')
        value = self._value()
        self._space()
        if self.i != len(self.s):
            raise ValueError('text after the mapping at {0}'.format(self.i))
        return value

    def _peek(self):
        return self.s[self.i] if self.i < len(self.s) else ''

    def _space(self):
        while self._peek() in (' ', '\t', '\n', '\r') and self._peek():
            self.i += 1

    def _expect(self, ch):
        self._space()
        if self._peek() != ch:
            raise ValueError('expected {0!r} at {1}'.format(ch, self.i))
        self.i += 1

    def _value(self):
        self._space()
        ch = self._peek()
        if ch == '{':
            return self._collection('}', True)
        if ch == '[':
            return self._collection(']', False)
        if ch in ('"', "'"):
            return self._quoted(ch)
        return _yaml_plain(self._plain())

    def _collection(self, close, mapping):
        self.i += 1
        out = {} if mapping else []
        while True:
            self._space()
            if self._peek() == close:
                self.i += 1
                return out
            if mapping:
                key = self._value()
                self._space()
                value = None
                if self._peek() == ':':
                    self.i += 1
                    value = self._value()
                try:
                    out[key] = value
                except TypeError:
                    raise ValueError('unhashable key {0!r}'.format(key))
            else:
                out.append(self._value())
            self._space()
            if self._peek() == ',':
                self.i += 1
            elif self._peek() != close:
                raise ValueError('expected "," or {0!r} at {1}'.format(
                    close, self.i))

    def _plain(self):
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            nxt = self.s[self.i + 1:self.i + 2]
            if ch in self._END or (ch == ':' and nxt in ('', ' ', '\t', '\n',
                                                         '\r', ',', '[',
                                                         ']', '{', '}')):
                break
            self.i += 1
        return self.s[start:self.i].strip()

    def _quoted(self, quote):
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise ValueError('unterminated quoted scalar')
            ch = self.s[self.i]
            self.i += 1
            if ch == quote:
                if quote == "'" and self._peek() == "'":  # '' is a quote
                    out.append("'")
                    self.i += 1
                    continue
                return ''.join(out)
            if ch == '\\' and quote == '"':
                esc = self._peek()
                self.i += 1
                if esc in _YAML_ESCAPES:
                    out.append(_YAML_ESCAPES[esc])
                elif esc in ('x', 'u', 'U'):
                    width = {'x': 2, 'u': 4, 'U': 8}[esc]
                    out.append(chr(int(self.s[self.i:self.i + width], 16)))
                    self.i += width
                else:
                    raise ValueError('unknown escape \\{0}'.format(esc))
            else:
                out.append(ch)
