"""Colour spaces of the plain reference: a 3x3 space is `<name>.json`
(matrices); a space that is not linear is `<name>.py`, a module of this
package (codec.space says what it defines)."""
