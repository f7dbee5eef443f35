"""SQL lexer.

The reference delegates SQL parsing to DataFusion's sqlparser
(rust/scheduler/src/lib.rs:236-249 parses SQL server-side). Built natively
here: tokens for the SQL subset covering TPC-H q1-q22 plus DDL
(CREATE EXTERNAL TABLE).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

from ballista_tpu_torch.errors import SqlError

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "like", "between", "is",
    "null", "true", "false", "case", "when", "then", "else", "end", "cast",
    "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "union", "all", "distinct", "exists", "any", "some", "asc", "desc",
    "nulls", "first", "last", "date", "interval", "timestamp", "time",
    "extract", "substring", "for", "create", "external", "table", "stored",
    "location", "with", "header", "row", "options", "explain", "analyze",
    "verbose", "escape", "over", "partition",
    "rows", "range", "unbounded", "preceding", "following", "current",
    "rollup", "cube", "grouping", "sets",
}


class Token(NamedTuple):
    kind: str  # keyword | ident | number | string | op | eof
    value: str
    pos: int


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    i = 0
    n = len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i)
            if j < 0:
                raise SqlError("unterminated block comment")
            i = j + 2
            continue
        if c == "'":
            # string literal with '' escape
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlError("unterminated string literal")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlError("unterminated quoted identifier")
            tokens.append(Token("ident", sql[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    seen_exp = True
                    j += 1
                    if j < n and sql[j] in "+-":
                        j += 1
                else:
                    break
            tokens.append(Token("number", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            if word.lower() in KEYWORDS:
                tokens.append(Token("keyword", word.lower(), i))
            else:
                tokens.append(Token("ident", word, i))
            i = j
            continue
        # operators
        for op in ("<>", "<=", ">=", "!=", "||"):
            if sql.startswith(op, i):
                tokens.append(Token("op", op, i))
                i += 2
                break
        else:
            if c in "+-*/%(),.;=<>":
                tokens.append(Token("op", c, i))
                i += 1
            else:
                raise SqlError(f"unexpected character {c!r} at {i}")
    tokens.append(Token("eof", "", n))
    return tokens
