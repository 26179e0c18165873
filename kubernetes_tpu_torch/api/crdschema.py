"""OpenAPI v3 schema validation for custom resources.

A copy of kubernetes_tpu/api/crdschema.py; its relative imports resolve in this
package.

The enforcement half of CustomResourceValidation (reference:
apiextensions-apiserver pkg/apiserver/validation/validation.go, which
delegates to go-openapi's SpecValidator). This is a self-contained
structural validator covering the keywords CRD authors actually use:
type, properties, required, items, enum, pattern, minimum/maximum,
minLength/maxLength, minItems/maxItems, additionalProperties, nullable.
Errors come back field-addressed, feeding the same 422 machinery as
built-in kinds.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_TYPE_CHECKS = {
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, list),
    "string": lambda v: isinstance(v, str),
    # bool is an int subclass in Python: exclude it from numerics
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "number": lambda v: isinstance(v, (int, float))
    and not isinstance(v, bool),
    "boolean": lambda v: isinstance(v, bool),
}


def validate_schema(value: Any, schema: dict,
                    path: str = "") -> List[Tuple[str, str]]:
    """value vs schema -> [(field_path, message)]; empty = valid."""
    errs: List[Tuple[str, str]] = []
    _walk(value, schema or {}, path or "<root>", errs)
    return errs


def schema_errors(schema: dict,
                  path: str = "openAPIV3Schema") -> List[Tuple[str, str]]:
    """Structural validation of the SCHEMA itself, run at CRD
    registration (apiextensions validation.go ValidateCustomResource
    Definition): a broken pattern or unknown type is the schema
    author's 422, not a fate inflicted on every future resource
    author."""
    errs: List[Tuple[str, str]] = []
    if not isinstance(schema, dict):
        errs.append((path, "schema must be an object"))
        return errs
    t = schema.get("type")
    if t is not None and t not in _TYPE_CHECKS:
        errs.append((f"{path}.type", f"unknown schema type {t!r}"))
    pat = schema.get("pattern")
    if pat is not None:
        try:
            re.compile(pat)
        except re.error as e:
            errs.append((f"{path}.pattern",
                         f"invalid regular expression {pat!r}: {e}"))
    for name, sub in (schema.get("properties") or {}).items():
        errs.extend(schema_errors(sub, f"{path}.properties[{name}]"))
    items = schema.get("items")
    if isinstance(items, dict):
        errs.extend(schema_errors(items, f"{path}.items"))
    addl = schema.get("additionalProperties")
    if isinstance(addl, dict):
        errs.extend(schema_errors(addl, f"{path}.additionalProperties"))
    return errs


def _walk(value, schema, path, errs):
    if value is None:
        if schema.get("nullable"):
            return
        # absent vs null is the caller's concern (required handles
        # absence); an explicit null against a typed schema fails
        if "type" in schema:
            errs.append((path, "must not be null"))
        return
    t = schema.get("type")
    if t is not None:
        check = _TYPE_CHECKS.get(t)
        if check is None:
            errs.append((path, f"unknown schema type {t!r}"))
            return
        if not check(value):
            errs.append((path, f"must be of type {t}"))
            return
    if "enum" in schema and value not in schema["enum"]:
        errs.append((path, f"must be one of {schema['enum']!r}"))
    if isinstance(value, str):
        pat = schema.get("pattern")
        if pat is not None:
            try:
                matched = re.search(pat, value) is not None
            except re.error:
                # a broken pattern in the CRD is a schema-author error,
                # reported as a field error rather than a 500 on every
                # write (the reference rejects it at CRD create)
                errs.append((path, f"schema pattern {pat!r} is not a "
                                   f"valid regular expression"))
                matched = True
            if not matched:
                errs.append((path, f"must match pattern {pat!r}"))
        if "minLength" in schema and len(value) < schema["minLength"]:
            errs.append((path,
                         f"length must be >= {schema['minLength']}"))
        if "maxLength" in schema and len(value) > schema["maxLength"]:
            errs.append((path,
                         f"length must be <= {schema['maxLength']}"))
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            errs.append((path, f"must be >= {schema['minimum']}"))
        if "maximum" in schema and value > schema["maximum"]:
            errs.append((path, f"must be <= {schema['maximum']}"))
    if isinstance(value, list):
        if "minItems" in schema and len(value) < schema["minItems"]:
            errs.append((path, f"must have >= {schema['minItems']} items"))
        if "maxItems" in schema and len(value) > schema["maxItems"]:
            errs.append((path, f"must have <= {schema['maxItems']} items"))
        items = schema.get("items")
        if isinstance(items, dict):
            for i, v in enumerate(value):
                _walk(v, items, f"{path}[{i}]", errs)
    if isinstance(value, dict):
        props = schema.get("properties", {})
        for req in schema.get("required", []):
            if req not in value:
                errs.append((f"{path}.{req}", "required value missing"))
        addl = schema.get("additionalProperties")
        for k, v in value.items():
            sub = props.get(k)
            if sub is not None:
                _walk(v, sub, f"{path}.{k}", errs)
            elif addl is False:
                errs.append((f"{path}.{k}",
                             "additional properties are not allowed"))
            elif isinstance(addl, dict):
                _walk(v, addl, f"{path}.{k}", errs)
